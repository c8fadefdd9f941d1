#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card, and check them.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (each failure ends the run with a non-zero exit code):

0. The card (``nvidia-smi`` name and power limit) and the torch/CUDA versions.
1. Build the kernels from ``flygym_tpu_torch/csrc`` with nvcc, all at
   once: the library of K1, K1b and the retina kernel K3, K3 at the other
   warps per block of ``K3_SWEEP_WARPS``, K3's profile build (its cull's
   keep mask), K3 as it stood before its redesign
   (``scripts/k3_before_redesign``), K1/K1b as they stood before their
   redesign (``scripts/k1_before_redesign``), and the mega-step
   kernel K2 for the benchmark fly, config 5's fly, config 3's terrain fly,
   example 11's two flies, the default two-fly contact preset, the 3-fly
   pile, the strict, muscle-driven and mixed-kind flies, the tethered
   fly (no contact candidate), the benchmark fly at condim 1, 4 and 6, and
   config 4's and config 2's worlds, the worlds the port composes for
   phases 45-47 and 60, config 5's world composed by the env (phase 53) and
   ``VectorFlyEnv()``'s (phases 54-56), example 11's world at condim 1, 4
   and 6 and on the blocks terrain with compressed pair rows (phases
   57-59), the worlds example 11 in torch composes (phase 61) and those
   examples 01, 02 and 12 in torch compose (phases 62-63) (one
   generated header each; worlds
   with the same header
   share its build), and for the benchmark fly K2's profile build (clock64
   phase counters), its builds at the other threads per block of
   ``SWEEP_THREADS`` and the profile build of K2 as it stood before its
   redesign (``scripts/k2_before_redesign``: one world per thread, scratch
   rows in global memory); print each build's seconds and the ptxas reports
   (registers, stack, spills), and for each header K2's threads per block,
   shared bytes per block, its scratch split between shared and global
   memory (floats per world) and the blocks per SM the card keeps resident.
2. Hold the tree-LDL factor (K1) and solve (K1b) kernels against their plain
   PyTorch versions at 4096 and at 1000 worlds of the benchmark fly and at
   1000 worlds of the default two-fly preset and of the 3-fly pile, within
   1e-5 of the largest plain value, and against their build before the
   redesign to the last bit in L, d and x (``scripts/k1_before_redesign/
   before.py`` launches it). Print the launch shape. At 4096 worlds, with
   CUDA events: the wrapper calls and the launches alone of the shipped
   and the before build in turns, the plain versions, ``torch.linalg``'s
   dense LDL and, labelled as a dense factor of the same H and not the same
   factor, ``cholesky_ex`` with ``cholesky_solve``; the shipped launches at
   1, 1024 and 16384 worlds; three bounds: what the kernels must move (H's
   envelope, L with its padding, d; for the solve L's chain entries, d, b
   and x), the envelope (L's chain entries only) and the dense one (all of
   H). The worlds per block were swept once by hand
   (``scripts/ldl_worlds_sweep.py``).
3. Hold K2 against its plain version (``ops/megastep.py:megastep_plain``)
   from the golden's settled state with the first replay targets: one K = 1
   launch against one plain step and one K = 8 launch against 8 chained
   plain steps (final state and qpos rows) at 4096 worlds, and one K = 1
   launch at 1000 worlds;
   time K = 1 and K = 8 launches at 4096 worlds, and the K = 8 launch at
   1024 and 16384 worlds (kernel only). Build K2 with 32, 64 and 128
   threads per block (one world per block), hold each against the shipped
   build and time their K = 8 launches at 4096 worlds in turns; print the
   share of each phase of K2's step from the profile build's counters,
   beside the shares of K2 before its redesign on the same launch (its
   outputs held equal to the shipped build's).
   Every check of K chained plain steps, here and in later phases, replays
   one captured plain step K times (``plain_steps``); this phase holds
   such a chain, its first step's every output too, against the eager
   chain at 1000 worlds and K = 2, to the last bit. A K = 1 check of a
   header that also makes a chain (here and in phases 10, 13, 16, 19, 21,
   24, 30 and 45) is held against that chain's first replay, on the
   chain's inputs (the first worlds, at a smaller width): one eager plain
   step fewer per header.
   (The plain version takes seconds per step whatever the worlds, so
   phases 3, 10, 13 and 16 hold K = 8 at 4096 worlds only; phases 3 and
   13 hold no second width at K = 8 and K = 1 respectively, phase 16 the
   default preset at 4096 only, and the pile's fused check runs K = 2
   steps, not 8.)
4. The main path, the mega-step: the benchmark fly in ``BatchSimulation``
   with its default step at 4096 worlds, adhesion on, bench.py's protocol
   (``demo/benchmark.py:run_simulation``): a 500-step settle (one step per
   launch: 8 does not divide 500), an untimed 1000-step replay of the
   Spotlight clip and a timed one from its end state (8 steps per launch).
   K2's launch count must be 750 (500 + 2 x 125), and K1/K1b's 0; all
   state finite.
5. The engine path (PR 1's): the same width through the eager engine step
   with K1/K1b, at a smaller depth, 100 settle + 2 x 200 replay steps; K1
   and K1b launches must be 500 and 1000, K2's 0.
6. The goldens: 8 worlds from the JAX settled state, 50 replay steps, the
   engine path against the JAX engine trajectory and the mega-step path
   against the JAX mega-step emitter's, to ``GOLDEN_TOLERANCE``
   (``flygym_tpu_torch/demo/benchmark.py``).
7. Hold the retina kernel K3 against its plain version
   (``ops/retina.py:retina_plain``) and against its build before the
   redesign, in both shading branches, at 4096 and 1000 worlds of config
   5's fly (the env golden's settled worlds with seeded pose noise) and at
   4096 adversarial worlds (every body moved by 0.3 mm of seeded noise):
   at least 99.9% of outputs within 1e-5 of the plain version, every output
   equal to the before build's to the last bit, all finite and in [0, 1].
   At 4096 worlds: each block shape's launch (threads, shared bytes, blocks
   per SM); the before build and K3 at each block shape timed in turns; the
   plain version and the acceptance blur; K3 alone at 1, 1024 and 16384
   worlds; the share of (tile, geom) pairs the cull keeps, from the profile
   build's keep mask on the card (which must hold every contributing pair
   of the worlds counted on the CPU) and from the host build (g++) on the
   CPU, beside the share that contributes; K3's bounds from the plain version's
   operations counted on the CPU: every (ray, geom) pair, and what these
   inputs need (each ray's own work and the contributing pairs).
8. The env path, config 5 (vision and odor RL env step) at 4096 worlds:
   ``VectorFlyEnv.make_batched_step`` with its defaults, 10 warm-up and 100
   timed env steps; launches K2 110 (K = 10 each), K3 110, K1/K1b 0; every
   observation finite, vision in [0, 1]; env-steps/s and world-steps/s; the
   split of one env step by CUDA events (K2, ``pack_rows``, K3, the blur,
   the rest); then 5 auto-reset steps from a
   batch with upside-down (done) worlds, which must come back as fresh
   reset states.
9. The env goldens: 8 worlds from the JAX settled env state, 5 env steps,
   the default path (K2 + K3) against the JAX emitter golden and the engine
   path (K1/K1b + K3) against the JAX engine golden: qpos and qvel to
   ``GOLDEN_TOLERANCE``, vision 99.5% within 1e-3, odor 1e-5 relative,
   reward 1e-6, done equal.
10. Hold K2 built for config 3's terrain fly (heightfield plane rows)
    against its plain version (the terrain golden's settled worlds with
    seeded root offsets and joint noise, planes from the port's sampler):
    one K = 1 launch at 4096 and 1000 worlds, one K = 8 launch at 4096, to
    ``K2_RTOL``; time
    K = 1 and K = 8 launches and the plane sampler at 4096 worlds; K2's
    bound from its operations counted on the CPU.
11. Config 3 (the hybrid controller on blocks terrain) at 4096 worlds:
    ``BatchSimulation`` with its default step, roots moved apart, adhesion
    on; a 504-step settle through ``rollout`` (63 K = 8 launches, 63 plane
    samples), then 1000 closed-loop steps of ``demo/hybrid_terrain.py``
    (1000 K = 1 launches, 125 samples). Launches K2 1063, samples 188,
    K1/K1b 0; all state finite; distance walked, world-steps/s, the split
    of one step by CUDA events, and no host synchronisation in a step.
12. The terrain goldens: 8 worlds from the JAX settled state, 48
    closed-loop steps, the K2 path against the JAX emitter golden with 0
    gaps (qpos, qvel, found flags, the CPG's phase) and the engine path
    (K1/K1b) against the JAX engine golden, to ``GOLDEN_TOLERANCE``.
13. Hold K2 built for example 11's two stacked flies (fly-fly pair rows)
    against its plain version (the two-fly golden's settled worlds with
    seeded root and joint noise): one K = 1 and one K = 8 launch at 4096
    worlds, to ``K2_RTOL``; time K = 1 and K = 8 launches at
    4096 worlds; K2's bound from its operations counted on the CPU.
14. Example 11 at 4096 worlds: ``BatchSimulation`` with its default step,
    the top fly moved by a seeded ±0.1 mm in xy per world, adhesion on the
    bottom fly, a timed ``rollout(None, 800)``: launches K2 100 (K = 8),
    K1/K1b 0; all state finite; in every world the top fly rests on the
    bottom one (root z 0.4 mm above it, example 11's check); the share of
    worlds with an active pair row. Then the engine path from the same drop,
    40 steps: K1 40, K1b 80, K2 0.
15. The two-fly goldens: 8 worlds from the JAX settled state, 16 steps, the
    K2 path against the JAX emitter golden to ``GOLDEN_TOLERANCE``, and the
    engine path against the JAX engine golden within 3 times the spread of
    the golden's conditioning probe at each step (or the floors
    ``PROBE_FLOOR``): the stacked flies are ill-conditioned.
16. Hold K2 built for compressed fly-fly pair rows against its plain
    version: the default two-fly contact preset (55 x 55 pair rows, 55
    groups) at 4096 worlds with one K = 1 and one K = 8 launch, and the
    3-fly pile (21 groups of 7) at 1000 with one K = 1 and one K = 2
    launch (no main path runs the pile), from each golden's settled worlds with
    seeded root and joint noise and the port's winner sampler's winners, to
    ``K2_RTOL``; time both worlds' K = 1 and K = 8 launches (the pile's
    kernel only) and one winner sample at 4096 worlds; K2's bounds from
    their operations counted on the CPU.
17. The default two-fly preset at 4096 worlds: ``BatchSimulation`` with its
    default step, the top fly moved by a seeded ±0.1 mm in xy per world,
    adhesion on the bottom fly, a timed ``rollout(None, 800)``: launches K2
    100 (K = 8), winner samples 100, K1/K1b 0; all state finite; in every
    world the top fly rests on the bottom one; the share of worlds with an
    active compressed row; world-steps/s and the card's busy share. Then the
    engine path from the same drop, 40 steps: K1 40, K1b 80, K2 0.
18. The goldens of both compressed presets, 8 worlds x 16 steps: the K2 path
    fed the JAX emitter's stored winners against the JAX emitter golden to
    ``GOLDEN_TOLERANCE``; the port's sampler on the same states against the
    stored winners (but near-ties within 1e-6 mm); the engine path against
    the JAX engine golden within the probe's bar, as in phase 15.
19. Hold K2 built for the strict replay's fly (``solver_exact``, 10 Newton
    iterations, the Hessian re-filled and re-factored at each) against its
    plain version: one K = 1 launch at 1000 worlds, one K = 8 launch at 4096
    against 8 chained plain steps, from the strict golden's settled worlds
    with seeded joint noise, to ``K2_RTOL``; time K = 1 and K = 8 launches
    at 4096 worlds; K2's bound from its operations counted on the CPU.
20. The strict replay at 4096 worlds: the replay protocol of phase 4 on the
    strict fly (``load_compiled(STRICT_FLY)``, ``BatchSimulation``,
    ``run_simulation``) with replays of ``CUT_REPLAY_STEPS``: launches K2
    600, K1/K1b 0, all state finite. Then
    its engine path at a small depth, 10 settle + 2 x 20 replay steps: 10 K1
    and 10 K1b launches per step.
21. Hold K2 built for the muscle-driven fly (42 muscles, na 42) and for the
    mixed-kind fly (one actuator kind per leg, na 14) against their plain
    versions, the activation rows compared too: for each, one K = 1 launch
    at 1000 worlds and one K = 8 launch at 4096 (seeded joint noise and
    activations in [0, 1]); time K = 1 and K = 8 launches at 4096 worlds.
22. The muscle-driven fly at 4096 worlds: ``BatchSimulation``,
    ``set_leg_adhesion_states``, ``set_actuator_inputs(fly, "muscle", ·)``
    with a seeded uniform draw in [0.3, 1.0] per world and muscle, and a
    timed ``rollout(None, 1000)`` from the drop: launches K2 125 (K = 8),
    K1/K1b 0, all state finite, activations in [0, 1]. Then the mixed-kind
    fly at 4096 worlds for 200 steps, each world holding one of the mixed
    golden's controls: launches K2 25.
23. The goldens of the three models, 8 worlds x 50 steps from the JAX
    settled state with the golden's controls: the K2 path against the JAX
    emitter with 0 gaps in qpos, qvel and the activations; the engine path
    (K1/K1b) against the JAX engine at each step to ``GOLDEN_TOLERANCE`` or,
    where the golden's conditioning probe spreads wider, to 3 times its
    spread, but only at the steps where that bar stays within
    ``PROBE_BAR_SHARE`` of the state's largest value (the mixed fly's
    ringing legs spread the probe wider than the state itself after a few
    steps; the steps held are printed); the activations within 1e-6.
24. Hold K2 built for the tethered motor fly (a hard weld, 42 MOTOR
    actuators, no contact candidate: qacc is the tree solve of Mh against
    the forces, K2 slice g.1) against its plain version: one K = 1 launch at
    1000 worlds, one K = 8 launch at 4096, from the tethered golden's
    settled worlds with seeded joint noise, to ``K2_RTOL``; time K = 1 and
    K = 8 launches at 4096 worlds; K2's bound from its operations counted on
    the CPU.
25. The tethered fly at 4096 worlds: ``BatchSimulation`` with its default
    step, ``set_actuator_inputs(fly, "motor", ·)`` with seeded torques in
    (-5, 5), a timed ``rollout(None, 1000)``: launches K2 125, K1/K1b 0;
    all state finite; world-steps/s.
26. The tethered golden, 8 worlds x 50 steps: the K2 path against the JAX
    emitter with 0 gaps, the engine path against the JAX engine to
    ``GOLDEN_TOLERANCE``.
27. The single-world API (B = 1): ``Simulation(load_compiled())`` with
    adhesion on, ``warmup()`` (500 K = 1 launches), 1000
    ``step_with_profile()`` calls (1000 K2 launches, no K1/K1b) equal to the
    last bit to a ``megastep_k=1`` ``rollout(None, 1000)`` from the same
    state; ``print_performance_report()``, ms per step and the realtime
    factor; ``save_state`` -> ``load_state`` equal to the last bit, and 10
    more steps of both equal; 100 ``step()`` calls of the tethered fly, equal
    to its K = 1 rollout.
28. The world sweep: ``run_benchmark(1, 16384, 4)`` (1, 4, ..., 16384
    worlds) at ``SWEEP_SETTLE`` and ``SWEEP_STEPS``, each count 150 K2
    launches, no K1/K1b, all state finite, and its world-steps/s; then
    ``python -m flygym_tpu_torch.demo.benchmark
    4096`` as a subprocess, whose last line must be bench.py's JSON line with
    a value > 0.
29. One ``utils.profiling.trace()`` (``torch.profiler``) of 8 K = 8 replay
    launches at 4096 worlds: the card's busy share and its top device op,
    which must be K2's kernel (the chrome trace in ``outputs/trace``).

30. Hold K2 built for the benchmark fly at condim 1, 4 and 6 (K2 slice
    g.3: 1, 6 and 10 pyramid rows per candidate, the torsional and rolling
    rows on the rotational Jacobian) against its plain version from each
    condim golden's settled worlds with seeded joint noise: one K = 1 launch
    at 1000 worlds for condim 1 and 4, and for condim 6 the launches its
    replay makes, K = 1 and K = 8 at 4096, to ``K2_RTOL``; time condim 6's
    K = 1 and K = 8 launches at 4096 worlds; its bound from its operations
    counted on the CPU. Then K2 with the terrain header at condim 6 (the
    terrain fly's candidates at 10 rows, their frames the sampled planes')
    against its plain version, one K = 1 launch at 1000 worlds.
31. The condim-6 replay at 4096 worlds: phase 4's protocol on the
    condim-6 fly with replays of ``CUT_REPLAY_STEPS``: launches K2 600,
    K1/K1b 0, all state finite.
32. The condim goldens (8 worlds; 4, 4 and 20 replay steps): the K2 path
    against the JAX emitter with 0 gaps, the engine path against the JAX
    engine within ``GOLDEN_TOLERANCE``.
33. Hold config 4's K = 20 launch (``demo/visual_taxis.py``: one per
    control step) against 20 chained plain steps on the card at 4096
    worlds, from the taxis golden's first control step with seeded joint
    noise, to ``K2_RTOL``; its time on those inputs and its bound.
34. Config 4 (example 07's visual taxis) at 4096 worlds, the batch built
    with ``megastep_k=20``: adhesion on, a 520-step settle (26 K = 20
    launches), 5 + 150 control steps, each one K3 launch (rows packed, then
    the blur), the drive, one CPG step and one K = 20 K2 launch: launches
    K2 26 + 155, K3 156, K1/K1b 0; all state
    finite; every world's left legs slowed at the first control step (the
    pillar lies to the left); the travel bearing beside the pillar's and
    the yaw turned; control steps/s, world-steps/s; the split of one control
    step by CUDA events (``pack_rows``, K3, blur, drive + CPG, K2); no host
    synchronisation in a control step.
35. Config 4 with one fly (B = 1), as phase 34: ms per control step and the
    realtime factor (20 x 0.1 ms of fly time per control step).
36. The taxis goldens, 8 worlds x 10 control steps from the JAX settled
    state: the vision and the drive at every control step, rendered from
    the poses each JAX path recorded, the vision within 1e-5 on
    ``RETINA_SHARE`` of the ommatidia and the drive within
    ``TAXIS_DRIVE_ATOL`` of what the vision's gap implies; the K2 path fed the JAX emitter loop's drives
    with 0 gaps in qpos, qvel and the CPG phase; the K2 and engine paths
    with their own vision within ``GOLDEN_TOLERANCE`` at the control steps
    where JAX's own engine and emitter agree within it (the first: from the
    second they part by up to ~6 in qvel), and at every control step within
    the bars of the JAX engine's conditioning probe (three times its spread
    from the settled state perturbed by 1e-5, or ``PROBE_FLOOR``).
37. Config 2 (example 04's CPG walking) at 4096 worlds: adhesion on, a
    520-step settle (65 K = 8 launches), 1000 steps of one CPG step and one
    K = 1 K2 launch: launches K2 65 + 1000, K1/K1b 0; world-steps/s; torch
    calls per step; no host synchronisation in a step.
38. The CPG walking goldens, 8 worlds x 40 steps: the K2 path with 0 gaps
    (qpos, qvel, phase), the engine path within ``GOLDEN_TOLERANCE`` where
    JAX's own two paths agree within it, and within the probe's bars at
    every step.
39. Soft welds and PGS on the engine path at 4096 worlds, 20 timed steps
    each from their goldens' settled worlds: the soft-welded fly one K1 and
    one K1b launch per step, its roots within 1e-3 mm of the tether; the
    PGS fly no K1/K1b (a dense Cholesky and the row-sequential sweeps); ms
    per step; the host synchronisations of one step of each, and none in
    the soft weld's forces; each golden (8 worlds x 20 steps) against the JAX engine
    within ``GOLDEN_TOLERANCE``.

40. The camera renderer (no kernel of its own: PyTorch operations, as the
    JAX package renders with plain jnp): each case of
    ``flygym_tpu_torch/assets/render_golden.npz`` (capsules, mesh SDFs, a
    targetbody camera, three lights with textures, 16 of 20 worlds in one
    call, config 3's heightfield, FlyEnv's frame) rendered on the card from
    the same state, held against the JAX frame and the port's CPU frame to
    ``FRAME_BARS`` (``demo/render_cases.py``).
41. The cases at full size (``RENDER_FULL``: one world at 240 x 320 with
    capsules and with mesh fidelity, 16 worlds at 120 x 160, the terrain
    at 240 x 320, FlyEnv's frame): each against the CPU's frame, ms per
    frame by CUDA events, the peak memory; a profiler trace of the capsule
    and mesh frames (device ops, busy share).
42. The render hooks with K2 between frames: ``Simulation`` with
    ``set_renderer("nmf/trackcam")``, 200 ``step_with_profile()`` +
    ``render_as_needed_with_profile()`` (200 K = 1 launches, 3 frames),
    the report; ``save_video`` where imageio or PIL is installed; the same for
    ``BatchSimulation`` of 16 worlds rendering all 16 at 120 x 160.
43. ``run_benchmark(1, 4, 4, enable_rendering=True)``: 750 K2 launches per
    run and one frame after each timed replay.
44. FlyEnv's frame function on the card without gymnasium; the retina of
    the terrain fly (heightfield) through the port of JAX's jnp path with
    no K3 launch, against the CPU's; config 5's flat retina one K3 launch.

45. The default benchmark world composed and compiled by the port
    (``demo/benchmark.py:make_model``, on the card machine's CPU): its
    arrays, initial state and metadata against ``benchmark_fly.npz``,
    bit-equal but ``can_invweight`` (``COMPOSED_BARS``) and up to two ulps
    of ``state.xquat`` (``tests/test_torch_compile.py``); K2 built for it
    against its plain version, one K = 1 and one K = 8 launch at 4096
    worlds; phase 4's replay protocol at 4096 worlds (750 K2 launches,
    world-steps/s); the golden's 50 steps from its settled state on the K2
    and the engine path against ``benchmark_fly_golden.npz`` to
    ``GOLDEN_TOLERANCE``.
46. ``make_model(trim_contacts=True)`` (36 candidates, no sensors) and
    ``make_model(simplify_geom=True)`` (capsule inertia): K2 for each
    against its plain version (K = 1 at 4096 worlds) and the replay
    protocol at 4096 worlds (750 launches, world-steps/s); the trimmed
    fly's largest root and centre-of-mass gaps after the replay against
    phase 45's run.
47. ``make_model(joints_preset=ALL_BIOLOGICAL, actuated_dofs_preset=ALL)``
    (nv 132) at 4096 worlds on the path the gate picks, printed with its
    reasons: a 500-step settle and a timed 1000-step rollout at the
    neutral targets, K2 against its plain version (K = 1) where the gate
    takes it. The tethered and the blocks-terrain worlds composed by the
    port (``demo/worlds.py``): one K2 launch each at 4096 worlds against K2
    built for the same world loaded from its ``.npz``.
48. ``to_mjcf_xml`` of the benchmark world: its SHA-256 equals the CPU's
    (``MJCF_SHA256``, ``tests/test_torch_compile.py``); without MuJoCo,
    ``launch_interactive_viewer`` raises an ImportError naming it.

49. The tree-LDL solve under autograd (``ops/ldl.py:tree_ldl_solve_grad``)
    at 4096 worlds of ``ldl.sample_problems``: its forward (one K1b launch)
    bit-equal to the wrapper's; gH and gb of its backward (one more K1b
    launch on the same factor) against autograd through the plain factor
    and solve on the card within ``GRAD_KERNEL_BAR``, gH only on the
    entries K1 reads; launches 0 K1, 1 K1b, 1 backward K1b; the forward and
    the forward with its backward timed, beside the plain versions'.
    K1 and K1b outside the Function, K2 and K3 given an input that
    requires grad raise.
50. Gradients through the engine step on the card: JAX's differentiable
    test's capsule composed by the port, its 15-step rollout's gradient
    with respect to qvel0 and to gravity against the JAX golden
    (``flygym_tpu_torch/assets/grad_golden.npz``) within
    ``GRAD_STEP_BAR``, against central differences within JAX's 5%, the
    forward with ``differentiable`` on and off bit-equal; the benchmark fly
    at B = 1 from its settled golden world, 2 steps, with the kernels and
    with the plain tree LDL on the card, each against the golden; example
    10's loss (``demo/gradient_optimization.stance_loss``) at 5 steps, its
    value and gradient at the golden's two offsets against JAX's within
    ``GRAD_STEP_BAR``; example 10 (``main``) at ``EXAMPLE_10``: the loss
    and seconds of each iteration, K1, K1b and backward K1b launches, no
    plain tree-LDL call.
51. ``utils/pose_conversion.convert_pose_axis_order`` from YPR to PRY on
    LEGS_ONLY on the card (2000 Adam steps, each cost and gradient one CUDA
    graph's replay): the body positions of both poses within
    ``POSE_BAR_MM``; the fit's seconds; the graph's gradient against the
    eager cost and backward's at 3 seeded qpos within ``GRAD_KERNEL_BAR``.

52. K2's pow (``ms_powf``, ``ops/megastep.py:kernel_powf``) against the
    plain ``powf`` on the card and on the CPU, to the last bit, over 2^20
    x (normal, tiny, subnormal, zero) at the exponents ``POWF_EXPONENTS``:
    a subnormal x reads as 2^-150, so x^y is nonzero below y ~0.84.
53. Config 5 on the env that composes its own world
    (``demo/multimodal_navigation.py:build_env``: ``_build_default_world``,
    the attractor, ``OdorField.for_fly``): its tables equal to
    ``env_fly.npz``'s; phase 8 on it at 4096 worlds (K2 110, K3 110,
    K1/K1b 0, env-steps/s, the split, auto-reset); its 8-world K2 path
    against the ``.npz`` env's from the env golden's settled state, 5 env
    steps, within ``GOLDEN_TOLERANCE`` (the composed compile's
    ``can_invweight`` parts from the file's in the last bits,
    ``tests/test_torch_compile.py``).
54. Example 06's batched half (``VectorFlyEnv()``, one env step: K2 1)
    and example 09 (3 env steps with vision and odor: K2 3, K3 3) at 4096
    worlds; no tree-LDL launch; observations finite.
55. Example 13 (``demo/rl_training_es.py:train``) at its own width, 1024
    envs x 100 env steps, and 10 of its 50 updates: seconds per update,
    the curve, K2 1,000 launches (K = 10), no K3 or tree-LDL launch.
56. Example 13 at ``--small`` (64 x 10 x 25: K2 250) with JAX's learning
    criterion (``tests/examples/test_rl_training.py``): the last two
    updates' mean reward above twice the first two's.

57. K2 with fly-fly pair rows at condim 1, 4 and 6 (slice g.3 on pair
    rows: the torsion and rolling rows on both bodies' signed paths):
    example 11's world at condim 1 and 4 composed by the port and
    ``twofly_condim6.npz``, each held against its plain version at
    ``PAIR_CHECK_WORLDS`` from the condim-6 golden's settled worlds with
    seeded root and joint noise, 0 gaps: condim 1 and 4 one K = 1 launch,
    condim 6 one K = 8 launch (phase 58's) against the chain of 8 plain
    steps; condim 6's K = 1 and K = 8 launches timed at 4096 worlds with
    their bounds.
58. Example 11 at condim 6 at 4096 worlds: ``rollout(None, 800)`` from the
    drop (K2 100, K1/K1b 0), example 11's check in every world,
    world-steps/s and the card's busy share; the engine path 8 steps (K1
    8, K1b 16); the golden (8 worlds x 16 steps): the K2 path 0 gaps to
    the JAX emitter, the engine path within 3 times the probe's spread.
59. Example 11's flies on the blocks terrain with compressed pair rows
    (slice g.2, ``twofly_terrain.npz``): K2 against its plain version, one
    K = 8 launch at ``PAIR_CHECK_WORLDS`` with the joint sampler's planes
    and winners against the chain of 8 plain steps, 0 gaps; the joint
    sampler on the card against the CPU (planes within ``PLANE_ATOL``,
    winners equal but near-ties); K2 and the sampler timed at 4096 worlds;
    the 800-step rollout at 4096 worlds (K2 100, winner samples 100, plane
    samples 100 or more, example 11's check in every world) and the engine
    path as in phase 58; the golden, the K2 path fed the stored planes and
    winners with 0 gaps.
60. ``JointPreset.ALL_POSSIBLE`` (nv 210; slice g.5) composed by the port:
    ``ALL_POSSIBLE_STEPS`` steps at 4096 worlds (K2 50, world-steps/s),
    then K2 against its plain version from the end state with seeded
    noise in qpos and qvel, one K = 1 launch at ``PAIR_CHECK_WORLDS``, 0
    gaps; K = 1 and K = 8 timed at 4096 worlds with their bounds.
61. Example 11 in torch (``demo/two_flies.main``) at 4096 worlds, at B = 1
    and at B = 1 at condim 1 and 4: K2 100 each, the example's check (but
    at condim 1, where the top fly slides off without friction), the
    240 x 320 PNG from ``bottom/trackcam``; ``twofly_condim6.npz`` at B = 1,
    the 800-step drop (the example's check) and 800 more steps timed.

62. Worlds split over 2 shards of cuda:0 (``parallel.make_world_mesh``):
    phase 4's replay through ``run_simulation(mesh=)`` (K2 2 x 750), its
    end state equal to phase 4's to the last bit, its world-steps/s beside
    phase 4's; from 4096 worlds made to differ, 64 steps (K = 8) of the
    terrain fly and of the default two-fly preset and 10 steps of the
    engine path (K1 and K1b per shard), each shard equal to the last bit
    to an unsharded batch of its own 2048 worlds, launches and winner
    samples as many; ``save_state`` / ``load_state`` through ``put_like``;
    example 12 in torch (8 shards of 4 worlds).
63. Examples 01, 02 and 03 in torch at their own sizes: 01's 500-step
    settle (K2 500, its MJCF equal to the JAX example's, every leg in
    contact as there), 02's settle and replay of the clip with its
    mesh-fidelity frame, 03 at 512 worlds (K2 750) with its montage.

``[time]`` lines give the seconds since the start after each group of
phases. The line before the last is a JSON summary of the kernels; the last
line is ``{"ok": true, "device": {...}}``.
"""

import contextlib
import json
import multiprocessing
import re
import shutil
import subprocess
import sys
import time
import warnings
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor, as_completed
from dataclasses import replace
from pathlib import Path
from unittest import mock

N_WORLDS = 4096
N_STEPS = 1000
# The strict and condim-6 replays (phases 20 and 31) replay this many steps,
# twice, after the 500-step settle: their rates are K2's (the card ~100% busy),
# and the shorter replays make room for phases 62-63 in the time limit.
CUT_REPLAY_STEPS = 400
SETTLE_STEPS = 500
ENGINE_STEPS = 200
ENGINE_SETTLE_STEPS = 100
MEGASTEP_K = 8
PILE_CHECK_K = 2  # the 3-fly pile's fused check (phase 16): no main path runs it
CHECK_WORLDS = (4096, 1000)
KERNEL_RTOL = 1e-5
ENV_WARMUP_STEPS = 10
ENV_STEPS = 100
ENV_ACTION_NOISE = 0.05  # rad around the neutral joint targets
AUTO_RESET_STEPS = 5
TERRAIN_SETTLE_STEPS = 504  # 63 K = 8 launches
TERRAIN_STEPS = 1000  # closed-loop steps, one K = 1 launch each
TERRAIN_RESAMPLE = 8
SPLIT_STEPS = 16
TWOFLY_STEPS = 800  # example 11's rollout: 100 K = 8 launches
TWOFLY_ENGINE_STEPS = 40
TOP_OFFSET_MM = 0.1
REST_GAP_MM = 0.4  # example 11's check: the top root this far above the bottom's
# The default two-fly preset's top fly slides off the bottom one in ~2% of
# the worlds, in the JAX engine too (PERF.md §6): its root then lies this
# far or farther from the bottom one's in xy.
SLIDE_OFF_MM = 1.5
STRICT_ENGINE_SETTLE_STEPS = 10
STRICT_ENGINE_STEPS = 20
STRICT_ITERATIONS = 10  # Newton iterations of the strict fly: K1 and K1b launches per step
MUSCLE_STEPS = 1000  # the muscle-driven rollout: 125 K = 8 launches
MUSCLE_CTRL = (0.3, 1.0)
MIXED_STEPS = 200
ACT_ATOL = 1e-6  # the engine path's activations against the JAX engine's
TETHER_TORQUE = 5.0  # the tethered fly's motors: forcerange and seeded torques in (-5, 5)
TETHERED_STEPS = 1000  # the tethered rollout: 125 K = 8 launches
SINGLE_STEPS = 1000  # step_with_profile() calls of the single-world fly (B = 1)
TETHERED_SINGLE_STEPS = 100
# The world-count sweep: run_benchmark(1, 16384, 4) runs 1, 4, 16, ..., 16384
# worlds (factor 16 from 1 would skip 16384), each a settle of SWEEP_SETTLE
# steps and two replays of SWEEP_STEPS (the benchmark's 500 and 1000 cut to
# make room; the benchmark entry's subprocess runs the full depth).
SWEEP_COUNTS = (1, 16384, 4)
SWEEP_SETTLE = 100  # 100 K = 1 launches: 8 does not divide it
SWEEP_STEPS = 200  # 25 K = 8 launches per replay
TRACE_LAUNCHES = 8  # K = 8 replay launches in the profiler's trace
# The actuator goldens' engine path is held at a step only where its bar
# (GOLDEN_TOLERANCE, or 3 times the conditioning probe's spread) is at most
# GOLDEN_TOLERANCE or this share of the JAX engine's largest |value|: past
# it the reference itself is not conditioned to tell a right step from a
# wrong one.
PROBE_BAR_SHARE = 0.1
NEAR_TIE_MM = 1e-6  # a group whose two nearest members lie this close may flip
# The two-fly engine golden: |port - JAX engine| at each step within 3 times
# |probe - JAX engine|, or these floors, as the JAX package's probe-gated
# test of the stacked flies (tests/tpu/test_megastep_tpu.py:436-437).
PROBE_FLOOR = {"qpos": 3e-5, "qvel": 5e-2}
# K3 against its plain version: the same fp32 operations in the same order,
# so they agree to the last bit except where a silhouette or checker edge
# flips on one ulp of a hit distance; outputs lie in [0, 1].
RETINA_ATOL = 1e-5
RETINA_SHARE = 0.999
# The env goldens' vision: the JAX package's bar for its retina kernel
# against its jnp oracle (tests/engine/test_retina_kernel.py:97-98).
VISION_GOLDEN = (1e-3, 0.995)
RETINA_BRANCHES = {"cone": None, "hard": 0.0}  # acceptance_fwhm_deg
# K2 against its plain version, as a share of the largest plain value of
# each output. The two run the same fp32 operations in the same order, with
# no fused multiply-adds, true divisions and the same sin/cos, so they agree
# to the last bit where nothing else differs (PERF.md has the measured
# gaps). The bar is one float32 ulp of the largest value, times 8 for the
# fused steps; it is far inside the emitter-vs-engine bars of
# tests/engine/test_megastep.py:120-145 (xpos 1e-5, qpos 1e-6 + 2e-4 dt,
# qvel 1e-3, qacc rtol 6e-3 / atol 0.2, actuator_force 1e-4, sensors 2e-3).
K2_RTOL = 1e-6
TIMED_LAUNCHES = 20
# K2's flat K = 8 launch is also timed at these widths, and built and timed
# at each of these threads per block (phase 3).
SWEEP_WORLDS = (1024, 16384)
SWEEP_THREADS = (32, 64, 128)
# K2 as it stood before its redesign, with its flat benchmark fly's header,
# profiled beside the shipped build (phase 3).
BEFORE_REDESIGN = Path(__file__).resolve().parent / "scripts" / "k2_before_redesign"
# K3 as it stood before its redesign (one thread per ray in lattice order,
# every geom swept): the redesign equals it to the last bit and is timed
# against it (phase 7).
K3_BEFORE = Path(__file__).resolve().parent / "scripts" / "k3_before_redesign" / "retina.cu"
# K3 alone is also timed at these widths (phase 7); 1 is one fly.
K3_SWEEP_WORLDS = (1, 1024, 16384)
# K3 is built with these warps per block besides the shipped build's, and
# all are timed in turns (phases 1 and 7).
K3_SWEEP_WARPS = (2, 8, 24)
# The adversarial poses of phase 7: the posed worlds with every body moved
# by this much seeded noise (mm), so that geoms cross eyes and each other.
BODY_NOISE_MM = 0.3
# Worlds of the posed batch whose operations and contributing pairs are
# counted on the CPU for K3's bounds (phase 7).
K3_COUNT_WORLDS = 64
# K1/K1b as they stood before their redesign (one thread per world over a
# dense world-minor copy of H): the redesign equals them to the last bit and
# is timed against them (phase 2).
K1_BEFORE = Path(__file__).resolve().parent / "scripts" / "k1_before_redesign" / "tree_ldl.cu"
# K1/K1b alone are also timed at these widths (phase 2).
LDL_SWEEP_WIDTHS = (1, 1024, 16384)
# Peak rates of one H100 SXM (NVIDIA's data sheet): fp32 outside the
# tensor cores, and HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# K2 slice g.3 (phases 30-32): the benchmark fly at condim 1, 4 and 6; the
# condim-6 header is timed and replayed at N_WORLDS.
CONDIMS = (1, 4, 6)
CONDIM_TIMED = 6
# Config 4 (phases 33-36): example 07's visual taxis, 20 physics steps per
# control step (one K = 20 K2 launch), 150 control steps as example 07 runs
# them, after a settle and a few untimed control steps.
TAXIS_SETTLE_STEPS = 520  # 26 K = 20 launches; also config 2's, 65 K = 8
TAXIS_WARMUP = 5
TAXIS_STEPS = 150
# The taxis's drive against the JAX golden's, both from their own vision:
# the retina within 1e-5 on 99.9% of the ommatidia (RETINA_SHARE), the
# means of 1442 of them times the gain 8.
TAXIS_DRIVE_ATOL = 1e-4
CPG_WALK_STEPS = 1000  # config 2 (phases 37-38): one K = 1 launch each
SOLVER_STEPS = 20  # soft welds and PGS (phase 39), engine steps timed
# Phases 45-48: the worlds the port composes. Their compile equals the JAX
# package's but for the fields torch's Cholesky rounds otherwise (relative
# bars, tests/test_torch_compile.py) and two ulps of the neutral pose's
# quaternions.
COMPOSED_BARS = {"model.can_invweight": 5e-5, "model.act_acc0": 2e-6}
XQUAT_ULPS = 2
# Phases 49-51: gradients through the step. The tree-LDL Function's
# gradients against autograd through the plain factor and solve on the card
# (the same sums in other orders; the plain scatters accumulate in an order
# that changes from run to run on CUDA), relative to the largest |g|.
GRAD_KERNEL_BAR = 1e-4
# The rollouts' gradients on the card against the JAX golden
# (scripts/export_grad_golden.py) and against the plain tree LDL on the
# card, relative to the largest |g|: the CPU holds them to 1e-4
# (tests/test_torch_grad.py); the card's reductions and matrix products sum
# in other orders, and the line search feeds back only the sign of phi',
# whose bracket one ulp can move, so a few steps from rest only.
GRAD_STEP_BAR = 1e-3
FD_BAR = 0.05  # JAX's bar for the gradient against central differences
EXAMPLE_10 = {"n_steps": 40, "n_iters": 3}  # example 10 reduced (its main: 400 and 30)
POSE_BAR_MM = 0.1  # tests/core/test_pose_conversion.py:68
GRAD_GOLDEN = Path(__file__).resolve().parent / "flygym_tpu_torch" / "assets" / "grad_golden.npz"
# make_model's options composed and run at N_WORLDS (phases 45-47).
COMPOSED_OPTIONS = {
    "benchmark": {},
    "trim_contacts": {"trim_contacts": True},
    "simplify_geom": {"simplify_geom": True},
    "all_biological": {"joints_preset": "all_biological", "actuated_dofs_preset": "all"},
    "all_possible": {"joints_preset": "all_possible", "actuated_dofs_preset": "all"},
}
# JAX's make_model docstring: the trimmed fly's COM within this of the full
# preset's over its flat-ground replay (flygym_tpu/demo/benchmark.py:57-68).
TRIM_CLAIM_MM = 1e-3
# SHA-256 of the benchmark world's MJCF (ModelSpec.to_mjcf_xml) as the CPU
# writes it, the JAX package's string too (tests/test_torch_compile.py).
MJCF_SHA256 = "6db61d17e20717efa5381470bc29192dcbda060fa191d5bb77dca2ffb61ac97e"
# Phases 57-61: example 11's two flies with pair rows at condim 1, 4 and 6
# and on the blocks terrain with compressed pair rows, and ALL_POSSIBLE.
PAIR_CONDIMS = (1, 4, 6)
# K2 against its plain version at this many worlds: one K = 8 launch, the
# main path's, for condim 6 and the terrain (phases 58-59 run 100 of them at
# 4096 worlds), one K = 1 launch for condim 1 and 4 and ALL_POSSIBLE.
PAIR_CHECK_WORLDS = 1000
ALL_POSSIBLE_STEPS = 400  # 50 K = 8 launches
# The engine path of phases 58-59 (condim 6: ~0.28 s a step at 4096 worlds).
PAIR_ENGINE_STEPS = 8
# The joint sampler's planes on the card against the CPU's and against the
# JAX golden's: the plane sampler on the card and XLA's jitted one have
# parted by up to ~6e-8 (the terrain golden's planes).
PLANE_ATOL = 1e-6
# Phase 62: the mesh's dry run, its shards on cuda:0.
MESH_SHARDS = 2
MESH_ROLLOUT = 64  # 8 K = 8 launches per shard
MESH_ENGINE_STEPS = 10


START = time.perf_counter()


def lap(what: str) -> None:
    print(f"[time] {what} done at {time.perf_counter() - START:.1f} s", flush=True)


class PhaseFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise PhaseFailed(what)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def time_ms(fn, n: int, warm_up: bool = True) -> float:
    """Mean milliseconds per call of ``fn`` over ``n`` calls, by CUDA events."""
    import torch

    if warm_up:
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def bound_ms(ops: float, nbytes: float) -> tuple:
    """The least time for ``ops`` fp32 operations moving ``nbytes``, and
    which of the two bounds it."""
    t_ops, t_bytes = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_build(worlds: dict, flat_model) -> None:
    """Every nvcc build at once, each timed: the model-independent library,
    K2 for each of ``worlds`` (name: compiled world), and for the flat
    benchmark fly ``flat_model`` K2's profile build, its builds at the
    other threads per block of SWEEP_THREADS and the profile build of K2
    before its redesign (BEFORE_REDESIGN). Then K2's launch for each
    world: threads per block, shared bytes per block, the scratch split
    between shared and global memory, resident blocks per SM."""
    from flygym_tpu_torch.ops import _build, megastep

    headers = {name: megastep.model_header(c.model)[0] for name, c in worlds.items()}
    extra = {f"benchmark fly, T={t}": (megastep.model_header(flat_model, t)[0], False, None)
             for t in SWEEP_THREADS if t != megastep.THREADS}
    extra["benchmark fly, profile"] = (headers["benchmark fly"], True, None)
    extra["benchmark fly, profile, before the redesign"] = (
        (BEFORE_REDESIGN / "megastep_model.h").read_text(), True,
        BEFORE_REDESIGN / "megastep.cu")

    def timed(fn, *args):
        t0 = time.perf_counter()
        path = fn(*args)
        return path, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=4 + len(K3_SWEEP_WARPS) + len(headers)
                            + len(extra)) as pool:
        jobs = {"K1, K1b, K3": pool.submit(timed, _build.build),
                "K3, profile": pool.submit(timed, _build.build_retina, None, True),
                "K3 before the redesign": pool.submit(timed, _build.build_retina, K3_BEFORE),
                "K1/K1b before the redesign": pool.submit(timed, _build.build_ldl, K1_BEFORE)}
        for warps in K3_SWEEP_WARPS:
            jobs[f"K3, {warps} warps"] = pool.submit(timed, _build.build_retina, None, False,
                                                     warps)
        # Worlds whose headers are the same text share one build.
        for header, name in {h: n for n, h in reversed(headers.items())}.items():
            jobs[f"K2, {name}"] = pool.submit(timed, _build.build_megastep, header)
        for name, (header, profile, source) in extra.items():
            jobs[f"K2, {name}"] = pool.submit(timed, _build.build_megastep, header, profile,
                                              source)
        done = {name: job.result() for name, job in jobs.items()}
    _build.load_library()
    for header in headers.values():
        _build.load_megastep(header)
    for name, (path, seconds) in done.items():
        print(f"[build] {path.parent.name}/{path.name} ({name}) in {seconds:.2f} s")
    reports = {"library": _build.ptxas_report(),
               **{name: _build.ptxas_report(library=done[name][0])
                  for name in ("K3 before the redesign", *(f"K3, {w} warps" for w in K3_SWEEP_WARPS),
                               "K1/K1b before the redesign")},
               **{f"K2 {name}": _build.ptxas_report(h) for name, h in headers.items()}}
    # K3's instantiations by shading branch.
    k3_name = re.compile(r"_Z\w*retina_kernelILb([01])E\w*")
    readable = lambda m: f"retina_kernel<{'cone' if m.group(1) == '1' else 'hard'}>"
    k1_name = re.compile(r"_Z\w*?((factor|solve)_kernel)\w*")
    for name, report in reports.items():
        for line in report.splitlines():
            if any(w in line for w in ("Compiling entry", "registers", "stack frame", "spill")):
                line = k1_name.sub(r"\1", k3_name.sub(readable, line.strip()))
                print(f"[build] {name} ptxas: {line}")
    for name, c in worlds.items():
        layout = megastep.scratch_layout(c.model)
        shape = megastep.kernel_shape(c.model)
        check(shape["shared_bytes"] == 4 * layout["n_shared"] <= megastep.SHARED_LIMIT
              and shape["blocks_per_sm"] >= 1, f"K2 {name}: launch shape {shape}")
        print(f"[build] K2 {name}: T={shape['threads']}, {shape['shared_bytes']} shared bytes "
              f"per block, scratch {layout['n_shared']} shared + {layout['n_global']} global "
              f"floats per world, {shape['blocks_per_sm']} blocks per SM")


def ldl_work(tables, B: int) -> dict:
    """Operations and bytes of one factor and one solve at B worlds: the
    tree elimination's multiplies, subtractions and divisions, and each input
    read and each output written once (fp32). "need" is what the kernels
    must move: H's envelope, L with its zero padding (its public shape) and
    d; for the solve L's chain entries, d, b and x. "envelope" writes only
    L's chain entries; "dense" reads all of H and, for the solve, all of L."""
    chains = (tables.dof_anc >= 0).sum(1).tolist()
    nv, maxc, n_chain, n_env = tables.nv, tables.maxc, tables.n_chain, tables.n_env
    factor_ops = sum(1 + n + n * (n + 1) for n in chains)
    solve_ops = 4 * n_chain + nv
    solve = (B * solve_ops, 4 * B * (n_chain + 3 * nv))
    return {
        "need": {"tree_ldl_factor": (B * factor_ops, 4 * B * (n_env + nv * maxc + nv)),
                 "tree_ldl_solve": solve},
        "envelope": {"tree_ldl_factor": (B * factor_ops, 4 * B * (n_env + n_chain + nv)),
                     "tree_ldl_solve": solve},
        "dense": {"tree_ldl_factor": (B * factor_ops, 4 * B * (nv * nv + nv * maxc + nv)),
                  "tree_ldl_solve": (B * solve_ops, 4 * B * (nv * maxc + 3 * nv))},
    }


def in_turns(runs: dict, n: int) -> dict:
    """Each of ``runs`` (name: callable) timed over ``n`` calls, in turns
    (the order, then reversed): name -> the two times."""
    turns = {name: [] for name in runs}
    for name in [*runs, *reversed(runs)]:
        turns[name].append(time_ms(runs[name], n))
    return turns


def ldl_launches(tables, H, b) -> dict:
    """The shipped K1 and K1b launched alone, on buffers made once."""
    import torch

    from flygym_tpu_torch.ops._build import load_library

    lib = load_library()
    B, nv, maxc = H.shape[0], tables.nv, tables.maxc
    n_env, n_chain = tables.n_env, tables.n_chain
    stream = torch.cuda.current_stream().cuda_stream
    L, d, x = H.new_empty((B, nv, maxc)), H.new_empty((B, nv)), b.new_empty((B, nv))
    factor = lambda: lib.tree_ldl_factor_f32(
        H.data_ptr(), L.data_ptr(), d.data_ptr(), tables.kernel.data_ptr(), nv, maxc, n_env,
        n_chain, B, stream)
    solve = lambda: lib.tree_ldl_solve_f32(
        L.data_ptr(), d.data_ptr(), b.data_ptr(), x.data_ptr(), tables.kernel.data_ptr(), nv,
        maxc, n_env, n_chain, B, stream)
    check(factor() == 0 and solve() == 0, "K1/K1b launch failed")
    return {"tree_ldl_factor": factor, "tree_ldl_solve": solve}


def k1_before():
    """``scripts/k1_before_redesign/before.py`` (K1/K1b's before build's
    launcher), loaded by its path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("k1_before_redesign",
                                                  K1_BEFORE.with_name("before.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_kernels(model, others: dict) -> dict:
    """K1 and K1b against the plain versions and the build before the
    redesign, on the benchmark fly and on ``others`` (name: model on the
    card); times in turns, library times and the bounds at N_WORLDS."""
    import torch

    from flygym_tpu_torch.engine import linalg
    from flygym_tpu_torch.ops import _build, ldl

    before_lib, BeforeBuild = _build.load_ldl(K1_BEFORE), k1_before().BeforeBuild
    tables = model.ldl
    err = {"tree_ldl_factor": 0.0, "tree_ldl_solve": 0.0}
    cases = [(f"B={n}", model, n) for n in CHECK_WORLDS]
    cases += [(f"{name} B={CHECK_WORLDS[1]}", m, CHECK_WORLDS[1]) for name, m in others.items()]
    for label, m, n in cases:
        H, b = ldl.sample_problems(m, n, seed=n)
        L, d = ldl.tree_ldl_factor(m.ldl, H)
        x = ldl.tree_ldl_solve(m.ldl, L, d, b)
        L0, d0 = linalg.tree_ldl_factor(m.ldl, H)
        x0 = linalg.tree_ldl_solve(m.ldl, L0, d0, b)
        Lb, db, xb = BeforeBuild(before_lib, m.ldl, H, b).run()
        torch.cuda.synchronize()
        for name, got, want, old, kernel in (
            ("L", L, L0, Lb, "tree_ldl_factor"),
            ("d", d, d0, db, "tree_ldl_factor"),
            ("x", x, x0, xb, "tree_ldl_solve"),
        ):
            abs_err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            same = torch.equal(got, old)
            print(f"[kernels] {label} {name}: max|kernel-plain| {abs_err:.3e}, "
                  f"max|plain| {scale:.3e}, ratio {abs_err / scale:.3e}; equal to the build "
                  f"before the redesign: {same} (max gap {(got - old).abs().max().item():.3e})")
            check(bool(torch.isfinite(got).all()), f"{name} not finite at {label}")
            check(abs_err <= KERNEL_RTOL * scale,
                  f"{name} at {label}: {abs_err:.3e} > {KERNEL_RTOL} * {scale:.3e}")
            check(same, f"{name} at {label} differs from K1/K1b before the redesign")
            err[kernel] = max(err[kernel], abs_err)
        check(L.is_contiguous() and d.is_contiguous() and x.is_contiguous(),
              f"K1/K1b outputs not batch-first contiguous at {label}")

    shape, sizes = ldl.kernel_shape(tables), ldl.shared_bytes(tables)
    print(f"[kernels] K1/K1b launch: {shape['threads']} threads per block; "
          + "; ".join(f"{k} {shape[k]['shared_bytes']} shared bytes per block, "
                      f"{shape[k]['blocks_per_sm']} blocks per SM"
                      for k in ("tree_ldl_factor", "tree_ldl_solve")))
    check(shape["threads"] == 32 * ldl.WORLDS
          and all(shape[k]["shared_bytes"] == sizes[k] for k in sizes),
          f"K1/K1b launch shape {shape} disagrees with ops/ldl.py ({ldl.WORLDS} worlds, {sizes})")

    # In turns at N_WORLDS: the wrapper calls, then the launches alone, of the
    # shipped and the before build. The before wrapper copied H (b) into its
    # world-minor buffer, then launched.
    H, b = ldl.sample_problems(model, N_WORLDS, seed=1)
    L, d = ldl.tree_ldl_factor(tables, H)
    old = BeforeBuild(before_lib, tables, H, b)
    check(old.factor() == 0 and old.solve() == 0, "K1/K1b before the redesign: launch failed")
    wrappers = {
        "tree_ldl_factor": {"before": lambda: (old.copy_H(), old.factor()),
                            "shipped": lambda: ldl.tree_ldl_factor(tables, H)},
        "tree_ldl_solve": {"before": lambda: (old.copy_b(), old.solve()),
                           "shipped": lambda: ldl.tree_ldl_solve(tables, L, d, b)},
    }
    alone = {"before": {"tree_ldl_factor": old.factor, "tree_ldl_solve": old.solve},
             "shipped": ldl_launches(tables, H, b)}
    times, before, launch = {}, {}, {}
    mean = lambda t: sum(t) / len(t)
    for name in ("tree_ldl_factor", "tree_ldl_solve"):
        call = in_turns(wrappers[name], TIMED_LAUNCHES)
        launched = in_turns({k: fns[name] for k, fns in alone.items()}, TIMED_LAUNCHES)
        before[name], launch[name] = mean(call["before"]), mean(launched["shipped"])
        times[name] = [mean(call["shipped"])]
        print(f"[kernels] {name} at B={N_WORLDS}, wrapper call: {times[name][0]:.4f} ms against "
              f"{before[name]:.4f} ms before the redesign ({before[name] / times[name][0]:.2f}x; "
              f"turns {' / '.join(f'{t:.4f}' for t in call['shipped'])} and "
              f"{' / '.join(f'{t:.4f}' for t in call['before'])}), on {card_line()}")
        for k, t in launched.items():
            print(f"[kernels] {name} at B={N_WORLDS}, launch alone, {k}: {mean(t):.4f} ms "
                  f"(turns {' / '.join(f'{x:.4f}' for x in t)})")
    plain = {"tree_ldl_factor": lambda: linalg.tree_ldl_factor(tables, H),
             "tree_ldl_solve": lambda: linalg.tree_ldl_solve(tables, L, d, b)}
    for name, fn in plain.items():
        times[name].append(time_ms(fn, TIMED_LAUNCHES))
    LD, pivots = torch.linalg.ldl_factor(H)
    C, info = torch.linalg.cholesky_ex(H)
    check(int(info.abs().max().item()) == 0, "cholesky_ex: H not positive definite")
    # One call each (seconds at this width), after the factor above made
    # the library's handle.
    library = {"tree_ldl_factor": time_ms(lambda: torch.linalg.ldl_factor(H), 1, warm_up=False),
               "tree_ldl_solve": time_ms(lambda: torch.linalg.ldl_solve(LD, pivots, b[..., None]),
                                         1, warm_up=False)}
    dense = {"tree_ldl_factor": time_ms(lambda: torch.linalg.cholesky_ex(H), TIMED_LAUNCHES),
             "tree_ldl_solve": time_ms(lambda: torch.cholesky_solve(b[..., None], C),
                                       TIMED_LAUNCHES)}
    for name in plain:
        print(f"[kernels] {name} at B={N_WORLDS}: plain {times[name][1]:.4f} ms; torch.linalg "
              f"ldl_{name.split('_')[-1]} {library[name]:.4f} ms; "
              f"{'cholesky_ex' if name == 'tree_ldl_factor' else 'cholesky_solve'} "
              f"{dense[name]:.4f} ms (a dense factor of the same H, not the same factor)")
    for n in LDL_SWEEP_WIDTHS:
        Hn, bn = ldl.sample_problems(model, n, seed=n + 1)
        fns = ldl_launches(tables, Hn, bn)
        print(f"[kernels] launch alone at B={n}: "
              + ", ".join(f"{k} {time_ms(f, TIMED_LAUNCHES):.4f} ms" for k, f in fns.items()))
    bounds = {}
    for kind, work in ldl_work(tables, N_WORLDS).items():
        for name, (ops, nbytes) in work.items():
            bound = bounds.setdefault(kind, {})[name] = bound_ms(ops, nbytes)
            print(f"[kernels] {name} {kind} bound at B={N_WORLDS}: {bound[0]:.4f} ms "
                  f"({bound[1]}: {ops:.3e} ops, {nbytes:.3e} bytes); wrapper call "
                  f"{times[name][0] / bound[0]:.1f}x it, launch alone "
                  f"{launch[name] / bound[0]:.1f}x, before {before[name] / bound[0]:.1f}x")
    return {"err": err, "times": times, "library": library, "bounds": bounds,
            "before_ms": before, "launch_ms": launch}


# K2's operation counts of the timed worlds, made in worker processes while
# the kernels build (``count_ops_in_background``): futures of (the model's
# K2 header, its megastep_ops).
OPS_COUNTS = []


def _ops_of(path: str, condim: int) -> tuple:
    """In a worker: (K2 header, megastep_ops) of the world at ``path``, of
    the terrain fly at ``condim`` (``terrain_at_condim``) where it is not 0,
    or of a world the port composes, ``compose:<name>`` (``compose``)."""
    import flygym_tpu_torch
    from flygym_tpu_torch.ops import megastep

    if path.startswith("compose:"):
        compiled = compose(path[len("compose:"):])[1].compiled
    else:
        compiled = terrain_at_condim(condim) if condim else flygym_tpu_torch.load_compiled(path)
    return megastep.model_header(compiled.model)[0], megastep_ops(compiled.model)


def count_ops_in_background(pool, worlds) -> None:
    """Start counting the ops of each of ``worlds`` ((path, condim) pairs, as
    ``_ops_of`` takes them) in ``pool``."""
    OPS_COUNTS.extend(pool.submit(_ops_of, str(path), condim) for path, condim in worlds)


def megastep_ops(model) -> int:
    """Elementwise operations of one world-step of K2's plain version (the
    JAX emitter's ops, its structural zeros and ones folded), counted on the
    CPU at one world, or taken from the background counts where one was
    made for the same header (a worker's OPS_COUNTS is empty)."""
    import torch
    from torch.overrides import TorchFunctionMode

    from flygym_tpu_torch.engine.model import make_initial_state
    from flygym_tpu_torch.ops import megastep

    if OPS_COUNTS:
        header = megastep.model_header(model.to("cpu"))[0]
        # The first count of this header to finish: the others need not end.
        for f in as_completed(OPS_COUNTS):
            if f.exception() is None and f.result()[0] == header:
                return f.result()[1]

    class Count(TorchFunctionMode):
        n = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if isinstance(out, torch.Tensor) and func not in (torch.zeros_like, torch.ones_like):
                Count.n += 1
            return out

    cpu = model.to("cpu")
    st = megastep._Static(cpu)
    s = make_initial_state(cpu, 1)
    cols = lambda x: [x[:, i] for i in range(x.shape[1])]
    args = [cols(s.qpos), cols(s.qvel), cols(s.ctrl), cols(s.act), cols(s.qacc)]
    # A heightfield world's planes and the compressed groups' winners are
    # inputs (level ground, first members here: the count does not depend
    # on their values).
    z, one = torch.zeros(1), torch.ones(1)
    terrain = [(z, z, z, one)] * st.ncand if st.has_hfield else None
    widx = [z] * len(st.pair_comp_groups) if st.pair_comp_groups else None
    with Count():
        megastep.emit_step(st, *args, terrain, widx)
    return Count.n


def k2_inputs(compiled, golden, n_worlds: int, k_steps: int):
    """The golden's settled worlds repeated to ``n_worlds`` on the card,
    with the first ``k_steps`` replay targets as a (K, B, nu) control
    sequence; the state carries the first."""
    import torch

    idx = torch.arange(n_worlds) % golden["targets"].shape[0]
    state = golden["state"].map(lambda x: x[idx].clone()).to("cuda")
    ids = torch.tensor(compiled.flies[compiled.fly_names[0]]["act_ids"]["position"], device="cuda")
    targets = torch.as_tensor(golden["targets"][:, :k_steps])[idx].cuda()
    seq = state.ctrl.expand((k_steps,) + state.ctrl.shape).clone()
    seq[:, :, ids] = targets.transpose(0, 1)
    return replace(state, ctrl=seq[0]), seq


def plain_steps(static, state, seq=None, planes=None, keep_first=False):
    """What ``megastep_plain(static, state, seq, planes)`` returns, in
    inference mode. One step (``seq`` None) runs eagerly. A chain of K
    steps captures one plain step in a CUDA graph and replays it once per
    step, each replay's state copied into the next one's inputs: the same
    ops on the same values as the eager chain, and so the same bits (phase
    3 holds a replayed chain, its first step's every output too, against
    the eager one). With ``keep_first`` the chain also returns its first
    replay's whole output, which is one plain step from ``state`` with
    ``seq[0]`` (``state.ctrl`` where the inputs hold ``ctrl = seq[0]``), and
    the milliseconds to it (the capture and one replay): ``(state, rows,
    first, first_ms)``. A plain step is
    ~300,000 to ~1,300,000 eager ops, on each of which the host spends
    ~10 us; a replay costs the card's time only. On an NVIDIA H100 80GB
    HBM3 at 700 W the benchmark fly's 8 steps at 4096 worlds took 10.7 s
    so, against 2.9 s for one eager step, and the strict fly's 33.4 s
    against 103.9 s eagerly."""
    import torch

    from flygym_tpu_torch.engine.maths import powf
    from flygym_tpu_torch.ops import megastep

    with torch.inference_mode():
        if seq is None:
            return megastep.megastep_plain(static, state, None, planes)
        t0 = time.perf_counter()
        powf(state.qpos[:1, :1].abs(), 2.0)  # its tables are made before the capture
        carried = ("qpos", "qvel", "act", "qacc")
        inp = replace(state, ctrl=seq[0].clone(),
                      **{f: getattr(state, f).clone() for f in carried})
        # Winners are checked on the host, which a capture cannot read:
        # checked here, before it, instead.
        winners = planes is not None and bool(static.pair_comp_groups)
        if winners:
            megastep._check_winners(static, megastep._split_aux(static, planes)[1])
        graph = torch.cuda.CUDAGraph()
        with mock.patch.object(megastep, "_check_winners", lambda *_: None) if winners \
                else contextlib.nullcontext(), torch.cuda.graph(graph):
            out = megastep.megastep_plain(static, inp, None, planes)
        rows = []
        for i in range(len(seq)):
            if i:
                inp.ctrl.copy_(seq[i])
                for f in carried:
                    getattr(inp, f).copy_(getattr(out, f))
            graph.replay()
            rows.append(out.qpos.clone())
            if keep_first and not i:
                first = replace(out.map(torch.clone), ctrl=seq[0],
                                time=state.time + static.timestep)
                torch.cuda.synchronize()
                first_ms = (time.perf_counter() - t0) * 1e3
        new = replace(out.map(torch.clone), ctrl=seq[-1],
                      time=state.time + len(seq) * static.timestep)
        del graph, out
        if keep_first:
            return new, torch.stack(rows), first, first_ms
        return new, torch.stack(rows)


def k2_against_plain(label: str, model, inputs, note=None,
                     checks=((N_WORLDS, 1), (N_WORLDS, MEGASTEP_K), (1000, 1)),
                     timed=True, entry_at=None) -> dict:
    """K2 built for ``model`` at K = 1 and K = MEGASTEP_K against its plain
    version at each (worlds, K) of ``checks``, on ``inputs(fn, n_worlds, k,
    seed) -> (state, (K, B, nu) controls, planes or winners or None)``, to
    K2_RTOL of the largest plain value of each output; ``note(state,
    planes)`` adds a word on the inputs to each line. Then, if ``timed``,
    the kernel's ms per launch at N_WORLDS (CUDA events, two runs) beside
    its plain version's (the check's call at N_WORLDS, host clock;
    None where ``checks`` lacks it), and each launch's bound from the plain
    version's operations. The plain version runs one eager op per operation
    of the kernel, so one step's time is the host's and hardly grows with
    the worlds; a chain of K steps is one captured step replayed K times
    (``plain_steps``), and its time is the capture's and the replays'.
    Where ``checks`` hold a chain, a K = 1 check at its width or a smaller
    one takes the chain's inputs (drawn from the chain's seed), its first
    worlds at a smaller width, and its launch is held against the chain's
    first replay on those worlds (the plain version computes each world
    alone; its plain time is the chain's capture and first replay) instead
    of an eager step of its own.
    With ``entry_at`` (one (worlds, K) of ``checks``) the kernel is also
    timed there, beside that check's plain time and the bound at that
    width (``entry``: the kernels line's numbers, ``k2_entry_at``)."""
    import torch

    from flygym_tpu_torch.ops import megastep

    fns = {k: megastep.make_megastep(model, k)
           for k in sorted({1, MEGASTEP_K, *(k for _n, k in checks)})}
    fields = ("qpos", "qvel", "qacc", "act", "xpos", "xquat", "actuator_force",
              "contact_sensordata")
    worst, plain_ms, plain_at = 0.0, {k: None for k in fns}, {}
    chain = max((c for c in checks if c[1] > 1), default=(0, 1))  # the widest chain
    from_chain = [c for c in checks if c[1] == 1 and c[0] <= chain[0]]
    first = None  # (state, planes, first plain step, its ms) of the chain
    for n, k in sorted(checks, key=lambda c: c[1] == 1):  # the chain first
        fn = fns[k]
        if (n, k) in from_chain:
            state, planes, want, plain = first
            state, want = state.map(lambda v: v[:n]), want.map(lambda v: v[:n])
            planes = None if planes is None else planes[:n]
            got = fn(state, planes)
        else:
            state, seq, planes = inputs(fn, n, k, n + k)
            got = fn(state, planes) if k == 1 else fn(state, seq, planes)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            keep_first = (n, k) == chain and bool(from_chain)
            want = plain_steps(fn.static, state, None if k == 1 else seq, planes, keep_first)
            torch.cuda.synchronize()
            plain = (time.perf_counter() - t0) * 1e3
            if keep_first:
                check(bool(torch.equal(state.ctrl, seq[0])),
                      f"{label}: the inputs' ctrl is not the chain's first control")
                *want, step1, step1_ms = want
                first = (state, planes, step1, step1_ms)
        plain_at[(n, k)] = plain
        if n == N_WORLDS:
            plain_ms[k] = plain
        pairs = []
        if k > 1:
            (got, traj), (want, wtraj) = got, want
            pairs.append(("qpos rows", traj, wtraj))
        pairs += [(f, getattr(got, f), getattr(want, f)) for f in fields
                  if getattr(want, f).numel()]
        gaps = []
        for name, a, b in pairs:
            gap, scale = (a - b).abs().max().item(), b.abs().max().item()
            check(bool(torch.isfinite(a).all()), f"{label} {name} not finite at B={n}, K={k}")
            check(gap <= K2_RTOL * scale,
                  f"{label} {name} at B={n}, K={k}: {gap:.3e} > {K2_RTOL} * {scale:.3e}")
            worst = max(worst, gap)
            gaps.append(f"{name} {gap:.2e}/{scale:.2e}")
        print(f"[{label}] B={n} K={k} max|kernel-plain|/max|plain|: " + ", ".join(gaps)
              + (f"; {note(state, planes)}" if note else "") + f"; plain {plain:.1f} ms"
              + (f" (the B={chain[0]} chain's capture and first replay)"
                 if (n, k) in from_chain else ""))

    entry = None
    if entry_at is not None:
        n, k = entry_at
        fn = fns[k]
        state, seq, planes = inputs(fn, n, k, 1)
        kernel = (lambda: fn(state, planes)) if k == 1 else (lambda: fn(state, seq, planes))
        n_in, n_out = megastep._io_rows(fn.static, k)
        ops = megastep_ops(model)
        bound = bound_ms(ops * k * n, 4 * (n_in + n_out) * n)
        entry = {"k": k, "worlds": n, "ms": time_ms(kernel, TIMED_LAUNCHES),
                 "plain_ms": plain_at[(n, k)], "bound": bound}
        print(f"[{label}] K={k} at B={n}: kernel {entry['ms']:.3f} ms per launch, plain "
              f"{entry['plain_ms']:.1f} ms, bound {bound[0]:.4f} ms ({bound[1]}; {ops} ops per "
              f"world-step), {entry['ms'] / bound[0]:.0f}x the bound")
    if not timed:
        return {"err": worst, "fns": fns, "entry": entry}
    times = {}
    for k in (1, MEGASTEP_K):
        fn = fns[k]
        state, seq, planes = inputs(fn, N_WORLDS, k, 1)
        kernel = (lambda: fn(state, planes)) if k == 1 else (lambda: fn(state, seq, planes))
        k1 = time_ms(kernel, TIMED_LAUNCHES)
        k2 = time_ms(kernel, TIMED_LAUNCHES, warm_up=False)
        times[k] = (0.5 * (k1 + k2), plain_ms[k])
        plain = "not timed" if plain_ms[k] is None else f"{plain_ms[k]:.1f} ms"
        print(f"[{label}] K={k} at B={N_WORLDS}: kernel {times[k][0]:.3f} ms per launch "
              f"(runs {k1:.3f}/{k2:.3f}), plain {plain}")

    ops = megastep_ops(model)
    bounds = {}
    for k in times:
        n_in, n_out = megastep._io_rows(fns[k].static, k)
        total_ops, nbytes = ops * k * N_WORLDS, 4 * (n_in + n_out) * N_WORLDS
        bounds[k] = bound_ms(total_ops, nbytes)
        print(f"[{label}] {ops} ops per world-step; K={k} launch at B={N_WORLDS}: "
              f"bound {bounds[k][0]:.4f} ms ({bounds[k][1]}: {total_ops:.3e} ops, "
              f"{nbytes:.3e} bytes), {times[k][0] / bounds[k][0]:.0f}x the bound")
    return {"err": worst, "times": times, "bounds": bounds, "fns": fns, "entry": entry}


def k2_entry_at(name: str, k2: dict, launches: int) -> dict:
    """The kernels line's entry of K2 built for one model, from the launch
    ``k2_against_plain`` timed at its ``entry_at``."""
    e = k2["entry"]
    return {
        "name": name,
        "route": "cuda",
        "source": "flygym_tpu_torch/csrc/megastep.cu",
        "replaces": "flygym_tpu/ops/megastep.py:2477",
        "launches": launches,
        "max_abs_err": k2["err"],
        "ms": e["ms"],
        "plain_ms": e["plain_ms"],
        "bound_ms": e["bound"][0],
        "bound_by": e["bound"][1],
        "library_ms": None,
        "k_steps": e["k"],
        "worlds": e["worlds"],
    }


def k2_entry(name: str, k2: dict, launches: int, k: int) -> dict:
    """The kernels line's entry of K2 built for one model: its K = ``k``
    launch, as the model's main path makes it."""
    return {
        "name": name,
        "route": "cuda",
        "source": "flygym_tpu_torch/csrc/megastep.cu",
        "replaces": "flygym_tpu/ops/megastep.py:2477",
        "launches": launches,
        "max_abs_err": k2["err"],
        "ms": k2["times"][k][0],
        "plain_ms": k2["times"][k][1],
        "bound_ms": k2["bounds"][k][0],
        "bound_by": k2["bounds"][k][1],
        "library_ms": None,
    }


def phase_megastep(compiled, model) -> dict:
    """K2 against its plain version; times and bounds at N_WORLDS; then the
    K = 8 launch at other widths and other threads per block, and its phase
    profile."""
    from flygym_tpu_torch.compose.bridge import load_golden

    golden = load_golden()
    k2 = k2_against_plain(
        "megastep", model, lambda fn, n, k, seed: (*k2_inputs(compiled, golden, n, k), None),
        checks=((N_WORLDS, 1), (N_WORLDS, MEGASTEP_K), (1000, 1)))
    fn = k2["fns"][MEGASTEP_K]
    plain_replay_is_eager(fn.static, *k2_inputs(compiled, golden, 1000, 2))
    for n in SWEEP_WORLDS:
        state, seq = k2_inputs(compiled, golden, n, MEGASTEP_K)
        ms_ = time_ms(lambda: fn(state, seq), TIMED_LAUNCHES)
        print(f"[megastep] K={MEGASTEP_K} at B={n}: kernel {ms_:.3f} ms per launch, "
              f"{n * MEGASTEP_K / ms_ * 1e3:.0f} world-steps/s of the kernel alone")
    state, seq = k2_inputs(compiled, golden, N_WORLDS, MEGASTEP_K)
    want = fn(state, seq)[0]
    thread_sweep(compiled.model, state, seq, want)
    k2_profile(model, state, seq, want)
    return k2


def plain_replay_is_eager(static, state, seq) -> None:
    """The plain chain replayed from its CUDA graph (``plain_steps``)
    against the eager chain of ``megastep_plain`` on the same inputs: every
    output and qpos row equal to the last bit."""
    import torch

    from flygym_tpu_torch.ops import megastep

    with torch.inference_mode():
        # The eager chain, one eager step at a time (megastep_plain chains
        # its steps so), each step's whole output kept.
        eager, cur = [], state
        for ctrl in seq:
            cur = megastep.megastep_plain(static, replace(cur, ctrl=ctrl), None)
            eager.append(cur)
    want = replace(eager[-1], time=state.time + len(seq) * static.timestep)
    wfirst = eager[0]
    wtraj = torch.stack([e.qpos for e in eager])
    got, traj, first, _ms = plain_steps(static, state, seq, keep_first=True)
    names = ("qpos", "qvel", "ctrl", "act", "time", "qacc", "xpos", "xquat", "site_xpos",
             "actuator_force", "contact_sensordata")
    pairs = [("qpos rows", traj, wtraj)] + [
        (f, getattr(got, f), getattr(want, f)) for f in names] + [
        (f"first step's {f}", getattr(first, f), getattr(wfirst, f)) for f in names]
    for name, a, b in pairs:
        check(a.shape == b.shape and bool(torch.equal(a, b)),
              f"the replayed plain chain's {name} differs from the eager chain's")
    print(f"[megastep] the plain chain replayed from one captured step against the eager "
          f"chain at B={state.qpos.shape[0]}, K={len(seq)}: all {len(pairs)} outputs, the "
          f"first step's too, equal to the last bit")


def thread_sweep(model, state, seq, want) -> None:
    """The flat K = 8 launch at N_WORLDS built for each of SWEEP_THREADS
    threads per block, called through its C function (not counted), timed
    in turns; each equal to the shipped build's result."""
    import torch

    from flygym_tpu_torch.ops import _build, megastep

    st = megastep._Static(model)
    packed = megastep._pack(st, state, seq, None, MEGASTEP_K)
    n_out = megastep._io_rows(st, MEGASTEP_K)[1]
    calls = {}
    for t in SWEEP_THREADS:
        lib = _build.load_megastep(megastep.model_header(model, t)[0])
        out = torch.empty((n_out, N_WORLDS), device="cuda")
        scratch = torch.empty((N_WORLDS, max(megastep.scratch_layout(model, t)["n_global"], 1)),
                              device="cuda")

        def call(lib=lib, out=out, scratch=scratch):
            megastep._raise_on_error(lib, lib.megastep_f32(
                packed.data_ptr(), out.data_ptr(), scratch.data_ptr(), N_WORLDS, MEGASTEP_K,
                torch.cuda.current_stream().cuda_stream))
            return out

        got = megastep._unpack(st, call(), state, seq[-1], MEGASTEP_K)[0]
        for name in ("qpos", "qvel", "qacc", "contact_sensordata"):
            check(torch.equal(getattr(got, name), getattr(want, name)),
                  f"K2 built with T={t}: {name} differs from the T={megastep.THREADS} build")
        calls[t] = call
    times = {t: [] for t in SWEEP_THREADS}
    for order in (SWEEP_THREADS, SWEEP_THREADS[::-1]):
        for t in order:
            times[t].append(time_ms(calls[t], TIMED_LAUNCHES // 2))
    for t in SWEEP_THREADS:
        shipped = " (shipped)" if t == megastep.THREADS else ""
        print(f"[megastep] T={t}{shipped}: K={MEGASTEP_K} at B={N_WORLDS}: "
              f"{'/'.join(f'{x:.3f}' for x in times[t])} ms per launch")


def k2_profile(model, state, seq, want) -> None:
    """Each phase's share of K2's step: the profile build's clock64()
    counters (one block's), the flat K = 8 launch at N_WORLDS, beside those
    of K2 before its redesign (one thread's), whose outputs must equal
    ``want``, the shipped build's (not counted)."""
    import re

    import torch

    from flygym_tpu_torch.ops import _build, megastep

    after = megastep.profile_megastep(model, state, seq)
    header = (BEFORE_REDESIGN / "megastep_model.h").read_text()
    lib = _build.load_megastep(header, profile=True, source=BEFORE_REDESIGN / "megastep.cu")
    n_scratch = int(re.search(r"N_SCRATCH = (\d+);", header).group(1))
    st = megastep._Static(model)
    packed = megastep._pack(st, state, seq, None, MEGASTEP_K)
    out = torch.empty((megastep._io_rows(st, MEGASTEP_K)[1], N_WORLDS), device="cuda")
    scratch = torch.empty((n_scratch, N_WORLDS), device="cuda")
    prof = torch.zeros((len(megastep.PROFILE_PHASES), N_WORLDS), dtype=torch.int64,
                       device="cuda")
    megastep._raise_on_error(lib, lib.megastep_profile_f32(
        packed.data_ptr(), out.data_ptr(), scratch.data_ptr(), prof.data_ptr(), N_WORLDS,
        MEGASTEP_K, torch.cuda.current_stream().cuda_stream))
    got = megastep._unpack(st, out, state, seq[-1], MEGASTEP_K)[0]
    for name in ("qpos", "qvel", "qacc", "xpos", "xquat", "actuator_force",
                 "contact_sensordata"):
        check(torch.equal(getattr(got, name), getattr(want, name)),
              f"K2 before its redesign: {name} differs from the shipped build")
    before = dict(zip(megastep.PROFILE_PHASES, prof.sum(dim=1).tolist()))
    totals = {"after": sum(after.values()), "before": sum(before.values())}
    check(min(totals.values()) > 0, "K2's profile counted no cycles")
    per_step = N_WORLDS * MEGASTEP_K
    print(f"[megastep] phase profile, K={MEGASTEP_K} at B={N_WORLDS}, outputs of K2 before "
          f"its redesign equal to the shipped build's: cycles per world-step "
          f"{totals['before'] / per_step:.0f} before (one thread's), "
          f"{totals['after'] / per_step:.0f} after (one block's)")
    for name, n in sorted(after.items(), key=lambda kv: -kv[1]):
        print(f"[megastep]   {name}: before {before[name] / totals['before']:.4f}, "
              f"after {n / totals['after']:.4f} ({n / per_step:.0f} cycles per world-step)")


def reset_counts() -> None:
    from flygym_tpu_torch.engine import contact
    from flygym_tpu_torch.ops import ldl, megastep, retina

    ldl.reset_launches()
    megastep.reset_launches()
    retina.reset_launches()
    contact.reset_samples()


def read_counts() -> dict:
    """Kernel launches, and the winner sampler's calls (``winners``)."""
    from flygym_tpu_torch.engine import contact
    from flygym_tpu_torch.ops import ldl, megastep, retina

    return {**ldl.launches, **megastep.launches, **retina.launches, **contact.samples}


def phase_slice(compiled, *, label: str, megastep, settle: int, steps: int, want: dict,
                return_sim: bool = False, mesh=None):
    """The replay benchmark at N_WORLDS through one path (its worlds split
    over ``mesh``, if given); returns the launch counts and the replay's
    walltime (and the simulation, with ``return_sim``)."""
    import torch

    from flygym_tpu_torch.demo.benchmark import ReplayTargetData, run_simulation

    fly = compiled.fly_names[0]
    dof_order = [tuple(d) for d in compiled.flies[fly]["actuated_dofs"]["position"]]
    targets = ReplayTargetData(compiled.model.timestep, dof_order).make_target_angles_all_worlds(
        N_WORLDS, steps
    )
    reset_counts()
    t0 = time.perf_counter()
    walltime, sim = run_simulation(
        compiled, targets, device="cuda", warmup_steps=settle, megastep=megastep, mesh=mesh
    )
    total = time.perf_counter() - t0
    counts = read_counts()
    print(f"[{label}] {N_WORLDS} worlds: settle {settle} + untimed replay {steps} + timed "
          f"replay {steps} steps in {total:.2f} s; launches {counts}")
    for name, n in want.items():
        check(counts[name] == n, f"{label}: {name} launches {counts[name]} != {n}")
    st = sim.state
    for name in ("qpos", "qvel", "qacc", "xpos", "xquat", "actuator_force", "contact_sensordata"):
        check(bool(torch.isfinite(getattr(st, name)).all()), f"{label}: state.{name} not finite")
    check(abs(sim.time - (settle + 2 * steps) * compiled.model.timestep) < 1e-3,
          f"time {sim.time}")
    found = st.contact_sensordata[..., 0].mean().item()
    z = st.qpos[:, 2]
    print(f"[{label}] root z min/mean/max {z.min().item():.4f}/{z.mean().item():.4f}/"
          f"{z.max().item():.4f} mm, contact found share {found:.3f}, "
          f"max|qvel| {st.qvel.abs().max().item():.2f}")
    rate = steps * N_WORLDS / walltime
    print(f"[{label}] replay {walltime:.3f} s, {walltime / steps * 1e3:.3f} ms per step: "
          f"{rate:.0f} world-steps/s on {card_line()}")
    return (counts, walltime, sim) if return_sim else (counts, walltime)


def phase_golden(compiled, *, label: str, golden_path, megastep: bool) -> None:
    """8 worlds from the JAX settled state, 50 replay steps vs a JAX trajectory."""
    from flygym_tpu_torch.compose.bridge import load_golden
    from flygym_tpu_torch.demo.benchmark import GOLDEN_TOLERANCE, track_golden

    golden = load_golden(golden_path)
    worst = track_golden(compiled, golden, device="cuda", megastep=megastep)
    n_worlds, n_steps = golden["targets"].shape[:2]
    print(f"[{label}] {n_worlds} worlds x {n_steps} steps vs JAX: max|dqpos| "
          f"{worst['qpos']:.3e}, max|dqvel| {worst['qvel']:.3e}, share of found flags "
          f"differing {worst['found_share']:.4f}; tolerances {GOLDEN_TOLERANCE}")
    for key, tol in GOLDEN_TOLERANCE.items():
        check(worst[key] <= tol, f"{label} {key}: {worst[key]:.3e} > {tol}")


def posed_states(env_compiled, model, n_worlds: int, seed: int):
    """The env golden's settled worlds repeated to ``n_worlds`` on the card,
    with seeded pose noise (root moved by up to 1.5 mm and turned by up to
    0.6 rad, joints by 0.05 rad) and the forward kinematics of the result."""
    import torch

    from flygym_tpu_torch.compose.bridge import load_env_golden
    from flygym_tpu_torch.engine.kinematics import forward_kinematics

    golden = load_env_golden()
    idx = torch.arange(n_worlds) % golden["state"].qpos.shape[0]
    state = golden["state"].map(lambda x: x[idx].clone()).to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qpos = state.qpos.clone()
    qpos[:, :2] += 3.0 * torch.rand((n_worlds, 2), generator=gen, device="cuda") - 1.5
    yaw = 1.2 * torch.rand(n_worlds, generator=gen, device="cuda") - 0.6
    qpos[:, 3:7] = torch.stack([torch.cos(yaw / 2), 0 * yaw, 0 * yaw, torch.sin(yaw / 2)], dim=1)
    qpos[:, 7:] += 0.05 * torch.randn(qpos[:, 7:].shape, generator=gen, device="cuda")
    xpos, xquat = forward_kinematics(model, qpos)
    return replace(state, qpos=qpos, xpos=xpos, xquat=xquat)


def retina_ops(tables, packed) -> tuple:
    """Elementwise operations of K3's plain version on CPU rows ``packed``,
    each weighted by its output's element count (arithmetic, comparisons and
    selects; views, copies and constants not counted); how many of them are
    selects (``where``); and the operations of the rays' own work (the same
    rows with no geoms: the rotation, the ground, the shading)."""
    import copy

    import torch
    from torch.overrides import TorchFunctionMode

    from flygym_tpu_torch.ops import retina as rk

    counted = {"add", "sub", "mul", "truediv", "div", "neg", "abs", "sqrt", "floor",
               "remainder", "clamp", "minimum", "maximum", "where", "lt", "gt", "le", "ge",
               "eq", "and", "or", "rsub", "radd", "rmul", "rtruediv", "reciprocal"}

    class Count(TorchFunctionMode):
        n = 0
        selects = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = getattr(func, "__name__", "").strip("_")
            if isinstance(out, torch.Tensor) and name in counted:
                Count.n += out.numel()
                Count.selects += out.numel() if name == "where" else 0
            return out

    with Count():
        rk.retina_plain(tables, packed)
    ops, selects = Count.n, Count.selects
    bare = copy.copy(tables)
    bare.G, bare.radius, bare.rgb = 0, tables.radius[:0], tables.rgb[:0]
    Count.n = 0
    with Count():
        rk.retina_plain(bare, packed[:, :14].contiguous())
    return ops, selects, Count.n


def posed_rows(env_compiled, model, tables, n_worlds: int, seed: int, body_noise: float = 0.0):
    """K3's rows of ``posed_states``; with ``body_noise``, every body moved
    by that much seeded noise (mm), the eyes and the geoms apart."""
    import torch

    from flygym_tpu_torch.ops import retina as rk

    state = posed_states(env_compiled, model, n_worlds, seed)
    xpos = state.xpos
    if body_noise:
        gen = torch.Generator(device="cuda").manual_seed(seed + 1)
        xpos = xpos + body_noise * torch.randn(xpos.shape, generator=gen, device="cuda")
    return rk.pack_rows(tables, xpos, state.xquat)


def launch_before(tables, packed):
    """One launch of K3 as it stood before its redesign (K3_BEFORE)."""
    import torch

    from flygym_tpu_torch.ops import _build

    lib = _build.load_retina(K3_BEFORE)
    B = packed.shape[0]
    out = torch.empty((B, 2, tables.R, 2), dtype=torch.float32, device=packed.device)
    err = lib.retina_before_f32(
        packed.data_ptr(), tables.dirs.data_ptr(), tables.weights.data_ptr(),
        tables.radius.data_ptr(), tables.rgb.data_ptr(), out.data_ptr(), B, tables.R, tables.G,
        tables.ground_z, tables.tanh_cone, int(tables.use_cone),
        torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"K3 before the redesign: launch error {err}")
    return out


def host_keep_mask(tables, packed):
    """K3's host build (g++) on CPU rows: its cull's keep mask (B, 2, T, G)
    bool, the cull counted on the CPU."""
    import torch

    from flygym_tpu_torch.ops import _build

    lib = _build.build_retina_host()
    B = packed.shape[0]
    out = torch.empty((B, 2, tables.R, 2))
    keep = torch.zeros((B, 2, tables.T, tables.G), dtype=torch.uint8)
    err = lib.retina_tiles_host_f32(
        packed.data_ptr(), tables.ray_index.data_ptr(), tables.tile_dirs.data_ptr(),
        tables.tile_weights.data_ptr(), tables.tile_axis.data_ptr(), tables.radius.data_ptr(),
        tables.rgb.data_ptr(), out.data_ptr(), keep.data_ptr(), B, tables.R, tables.T, tables.G,
        tables.ground_z, tables.tanh_cone, int(tables.use_cone))
    check(err == 0, "K3's host build failed")
    return keep.bool()


def phase_retina(env_compiled, model) -> dict:
    """K3 against its plain version and against its build before the
    redesign in both branches; the block shapes and the before build timed
    in turns, K3 at other widths, the cull's kept share, both bounds, the
    blur's time (N_WORLDS, default cone branch)."""
    import torch

    from flygym_tpu_torch.ops import retina as rk
    from flygym_tpu_torch.vision import Retina

    worst = 0.0
    for branch, fwhm in RETINA_BRANCHES.items():
        retina = Retina.for_compiled(env_compiled, acceptance_fwhm_deg=fwhm)
        kern = rk.make_retina_kernel(model, retina)
        tables = kern.tables
        check(tables.use_cone == (branch == "cone"), f"{branch}: wrong shading branch")
        cases = [(f"B={n}", posed_rows(env_compiled, model, tables, n, seed=n))
                 for n in CHECK_WORLDS]
        cases.append((f"B={N_WORLDS} adversarial", posed_rows(
            env_compiled, model, tables, N_WORLDS, seed=7, body_noise=BODY_NOISE_MM)))
        for label, packed in cases:
            got, want = rk.launch_retina(tables, packed), rk.retina_plain(tables, packed)
            before = launch_before(tables, packed)
            torch.cuda.synchronize()
            gap = (got - want).abs()
            share = (gap <= RETINA_ATOL).float().mean().item()
            flips = int((gap > RETINA_ATOL).sum().item())
            same = torch.equal(got, before)
            print(f"[retina] {branch} {label}: share within {RETINA_ATOL} {share:.6f}, "
                  f"max gap {gap.max().item():.3e}, flips {flips} of {gap.numel()}, "
                  f"exact {(gap == 0).float().mean().item():.6f}; equal to the build before "
                  f"the redesign: {same} (max gap {(got - before).abs().max().item():.3e})")
            check(bool(torch.isfinite(got).all()), f"K3 {branch} not finite at {label}")
            check(got.min().item() >= 0.0 and got.max().item() <= 1.0,
                  f"K3 {branch} outside [0, 1] at {label}")
            check(share >= RETINA_SHARE, f"K3 {branch} at {label}: share {share} < {RETINA_SHARE}")
            check(same, f"K3 {branch} at {label} differs from K3 before the redesign")
            worst = max(worst, gap.max().item())

    retina = Retina.for_compiled(env_compiled)
    render = retina.make_render_batched(model)
    tables = render.kernel.tables
    packed = posed_rows(env_compiled, model, tables, N_WORLDS, seed=1)
    points = rk.launch_retina(tables, packed)
    shipped = rk.kernel_shape(tables)["threads"] // rk.TILE
    for warps in (shipped, *K3_SWEEP_WARPS):
        shape = rk.kernel_shape(tables, None if warps == shipped else warps)
        print(f"[retina] K3 with {warps} warps per block: {shape['threads']} threads, "
              f"{shape['shared_bytes']} shared bytes per block, {shape['blocks_per_sm']} blocks "
              f"per SM, {-(-tables.T // warps)} blocks per eye ({tables.T} tiles)")
    for warps in K3_SWEEP_WARPS:
        check(torch.equal(rk.launch_build(tables, packed, warps), points),
              f"K3 with {warps} warps per block differs from the shipped build")
    # In turns: the before build, each block shape, then back.
    runs = {"before the redesign": lambda: launch_before(tables, packed),
            f"{shipped} warps": lambda: rk.launch_retina(tables, packed)}
    for warps in K3_SWEEP_WARPS:
        runs[f"{warps} warps"] = lambda w=warps: rk.launch_build(tables, packed, w)
    turns = in_turns(runs, TIMED_LAUNCHES)
    mean = {name: sum(t) / len(t) for name, t in turns.items()}
    for name, t in turns.items():
        print(f"[retina] K3 {name} at B={N_WORLDS}: {mean[name]:.4f} ms "
              f"(turns {' / '.join(f'{x:.4f}' for x in t)})")
    k3, before = mean[f"{shipped} warps"], mean["before the redesign"]
    print(f"[retina] shipped K3 ({shipped} warps) {k3:.4f} ms against {before:.4f} ms before the "
          f"redesign: {before / k3:.2f}x, on {card_line()}")
    p = time_ms(lambda: rk.retina_plain(tables, packed), 1)
    blur = time_ms(lambda: render.blur(points), TIMED_LAUNCHES)
    print(f"[retina] K3 at B={N_WORLDS}: plain {p:.1f} ms, acceptance blur (torch.einsum) "
          f"{blur:.4f} ms")
    for n in K3_SWEEP_WORLDS:
        rows = posed_rows(env_compiled, model, tables, n, seed=n + 1)
        t = time_ms(lambda rows=rows: rk.launch_retina(tables, rows), TIMED_LAUNCHES)
        print(f"[retina] K3 at B={n}: {t:.4f} ms ({n * 2 * tables.R / t * 1e3:.3e} rays/s)")

    # The cull's kept share: the profile build's keep mask on the card, the
    # host build's on the CPU; the contributing pairs from the plain
    # arithmetic, each of which the card's mask must hold.
    profiled, keep = rk.keep_mask(tables, packed)
    torch.cuda.synchronize()
    check(torch.equal(profiled, points), "K3's profile build differs from the shipped build")
    kept, n_pairs = int(keep.sum().item()), keep.numel()
    cpu_tables = rk.RetinaTables(env_compiled.model, retina)
    rows = packed[:K3_COUNT_WORLDS].cpu()
    host = host_keep_mask(cpu_tables, packed.cpu()) if shutil.which("g++") else None
    contrib = rk.contributing_pairs(cpu_tables, rows)  # (b, 2, R, G)
    slots = cpu_tables.ray_index.long().reshape(2, tables.T, rk.TILE)
    tiles = torch.stack([(contrib[:, e][:, slots[e].clamp(min=0)]
                          & (slots[e] >= 0)[None, :, :, None]).any(dim=2) for e in range(2)], 1)
    missed = int((tiles & ~keep[:K3_COUNT_WORLDS].cpu()).sum())
    check(missed == 0, f"K3's cull on the card dropped {missed} contributing (tile, geom) pairs")
    pair_share = contrib.float().mean().item()
    host_note = "not measured (no g++)" if host is None else (
        f"{host.float().mean().item():.4f}, {int((host != keep.cpu()).sum())} flags apart from "
        f"the card's")
    print(f"[retina] cull at B={N_WORLDS}: kept {kept} of {n_pairs} (tile, geom) pairs, share "
          f"{kept / n_pairs:.4f} on the card; the host build keeps {host_note} on the CPU; of "
          f"the first {K3_COUNT_WORLDS} worlds' pairs {tiles.float().mean().item():.4f} (tile, "
          f"geom) and {pair_share:.4f} (ray, geom) contribute (CPU), none of them culled on the card")

    # Bounds: every (ray, geom) pair as the plain version sweeps them, and
    # what these inputs need: each ray's own work and the contributing pairs.
    ops, selects, ray_ops = retina_ops(cpu_tables, rows)
    per_world = ops / K3_COUNT_WORLDS
    need_per_world = (ray_ops + (ops - ray_ops) * pair_share) / K3_COUNT_WORLDS
    table_bytes = 4 * sum(t.numel() for t in (tables.dirs, tables.weights, tables.radius, tables.rgb))
    nbytes = 4 * (packed.numel() + points.numel()) + table_bytes
    bound = bound_ms(per_world * N_WORLDS, nbytes)
    need = bound_ms(need_per_world * N_WORLDS, nbytes)
    blur_ops = 2 * 2 * (2 * N_WORLDS) * tables.R * tables.R
    nonzeros = (retina.blur_weights != 0).sum(axis=2).mean(axis=1)
    pairs = 2 * tables.R * tables.G
    print(f"[retina] {per_world:.0f} ops per world ({(per_world - ray_ops / K3_COUNT_WORLDS) / pairs:.1f}"
          f" per ray-geom pair, of which {selects / K3_COUNT_WORLDS / pairs:.1f} are selects; "
          f"-fmad=false issues none as an FMA, where the fp32 peak counts an FMA as two ops), "
          f"{ray_ops / K3_COUNT_WORLDS:.0f} of them the rays' own; at B={N_WORLDS}: bound, all "
          f"pairs, {bound[0]:.4f} ms ({bound[1]}), K3 {k3 / bound[0]:.2f}x it, before "
          f"{before / bound[0]:.2f}x; bound, what these inputs need ({need_per_world:.0f} ops per "
          f"world, {nbytes:.3e} bytes), {need[0]:.4f} ms ({need[1]}), K3 {k3 / need[0]:.1f}x it, "
          f"before {before / need[0]:.1f}x; blur {blur_ops:.3e} fp32 ops "
          f"({blur_ops / PEAK_FP32 * 1e3:.4f} ms at the fp32 peak), its rows hold "
          f"{nonzeros[0]:.2f} (pale) and {nonzeros[1]:.2f} (yellow) nonzeros on average")
    return {"err": worst, "times": (k3, p), "bound": need, "bound_all_pairs": bound,
            "before_ms": before, "kept_share": kept / n_pairs, "blur_ms": blur}


def env_actions(env, n_steps: int, seed: int) -> list:
    """Neutral joint targets plus seeded noise, adhesion on, per step."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    neutral = env._state0.ctrl[0, env._act_ids]
    ones = torch.ones((N_WORLDS, 6), device="cuda")
    return [
        {"joints": neutral + ENV_ACTION_NOISE * torch.randn(
            (N_WORLDS, env.n_actuated), generator=gen, device="cuda"), "adhesion": ones}
        for _ in range(n_steps)
    ]


def phase_env(env, label: str = "env") -> tuple:
    """Config 5 at N_WORLDS through the default env step of ``env`` (a
    ``VectorFlyEnv`` with vision and odor on the card); returns the launch
    counts and the timed steps' walltime."""
    import torch

    from flygym_tpu_torch.ops import retina as rk

    check(env.megastep, f"{label}: the env's default step is not the mega-step on the card")
    step = env.make_batched_step()
    gen = torch.Generator(device="cuda").manual_seed(0)
    actions = env_actions(env, ENV_WARMUP_STEPS + ENV_STEPS, seed=1)
    states = env.reset_batched(gen, N_WORLDS)
    ok = torch.ones((), dtype=torch.bool, device="cuda")

    def checked(obs):
        nonlocal ok
        for v in obs.values():
            ok = ok & torch.isfinite(v).all()
        ok = ok & (obs["vision"].min() >= 0.0) & (obs["vision"].max() <= 1.0)

    torch.cuda.synchronize()
    reset_counts()
    for a in actions[:ENV_WARMUP_STEPS]:
        states, obs, reward, done, _ = step(states, a)
        checked(obs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for a in actions[ENV_WARMUP_STEPS:]:
        states, obs, reward, done, _ = step(states, a)
        checked(obs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    n_steps = ENV_WARMUP_STEPS + ENV_STEPS
    print(f"[{label}] config 5, {N_WORLDS} worlds: {ENV_WARMUP_STEPS} + {ENV_STEPS} env steps "
          f"({env.decision_interval} physics steps each); launches {counts}")
    for name, n in {"megastep": n_steps, "retina": n_steps,
                    "tree_ldl_factor": 0, "tree_ldl_solve": 0}.items():
        check(counts[name] == n, f"{label}: {name} launches {counts[name]} != {n}")
    check(bool(ok.item()), f"{label}: an observation is not finite, or vision is outside [0, 1]")
    for name in ("qpos", "qvel", "xpos"):
        check(bool(torch.isfinite(getattr(states, name)).all()),
              f"{label}: state.{name} not finite")
    z = states.qpos[:, 2]
    print(f"[{label}] root z min/mean/max {z.min().item():.4f}/{z.mean().item():.4f}/"
          f"{z.max().item():.4f} mm, done share {done.float().mean().item():.4f}, "
          f"reward mean {reward.mean().item():.3e}, vision mean {obs['vision'].mean().item():.4f}, "
          f"odor mean {obs['odor_intensity'].mean().item():.3e}")
    rate = ENV_STEPS * N_WORLDS / wall
    print(f"[{label}] {ENV_STEPS} timed env steps in {wall:.3f} s, {wall / ENV_STEPS * 1e3:.3f} ms "
          f"per env step: {rate:.0f} env-steps/s, {rate * env.decision_interval:.0f} "
          f"world-steps/s on {card_line()}")

    # The split of one env step, by CUDA events over 5 steps.
    render = env.render_vision
    tables = render.kernel.tables
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    parts = [0.0] * 5
    for a in actions[:5]:
        ev[0].record()
        states = env._advance(states, a)
        ev[1].record()
        packed = rk.pack_rows(tables, states.xpos, states.xquat)
        ev[2].record()
        points = rk.launch_retina(tables, packed)
        ev[3].record()
        render.blur(points)
        ev[4].record()
        env._observe_body(states)
        env._reward_done(states)
        ev[5].record()
        ev[5].synchronize()
        for i in range(5):
            parts[i] += ev[i].elapsed_time(ev[i + 1]) / 5
    print(f"[{label}] one env step: K2 launch with its packing {parts[0]:.3f} ms, "
          f"K3's packing (pack_rows) {parts[1]:.3f} ms, K3 {parts[2]:.3f} ms, "
          f"blur {parts[3]:.3f} ms, observations, odor, reward and done {parts[4]:.3f} ms")

    # Auto-reset: every fourth world upside down (flipped: done).
    auto = env.make_batched_step(auto_reset=True)
    qpos = states.qpos.clone()
    qpos[::4, 3:7] = torch.tensor([0.0, 1.0, 0.0, 0.0], device="cuda")
    states = replace(states, qpos=qpos)
    n_done = 0
    for i, a in enumerate(actions[:AUTO_RESET_STEPS]):
        probe = torch.Generator(device="cuda")
        probe.set_state(gen.get_state())
        fresh = env.reset_batched(probe, N_WORLDS)
        states, obs, reward, done, _ = auto(states, a, gen)
        if i == 0:
            flipped = torch.zeros(N_WORLDS, dtype=torch.bool, device="cuda")
            flipped[::4] = True
            check(bool(done[flipped].all()), f"{label} auto-reset: a flipped world is not done")
        n_done += int(done.sum().item())
        for name in ("qpos", "qvel", "xpos", "time"):
            got, want = getattr(states, name)[done], getattr(fresh, name)[done]
            check(torch.equal(got, want),
                  f"{label} auto-reset step {i}: done worlds' {name} not fresh")
        check(bool(torch.isfinite(obs["vision"]).all()),
              f"{label} auto-reset step {i}: vision not finite")
    print(f"[{label}] auto-reset: {AUTO_RESET_STEPS} steps, {n_done} done worlds replaced by "
          f"fresh states")

    # The method entry points render through K3 too: one launch per step.
    before = rk.launches["retina"]
    states, obs, _reward, _done, _ = env.step(states, actions[0])
    env.observe(states)
    check(rk.launches["retina"] == before + 2,
          f"{label}: env.step and env.observe: {rk.launches['retina'] - before} K3 launches, not 2")
    check(bool(torch.isfinite(obs["vision"]).all()), f"{label}: env.step: vision not finite")
    return counts, wall


def phase_env_golden(env_compiled, *, label: str, megastep) -> None:
    """8 worlds from the JAX settled env state, 5 env steps vs a JAX path."""
    import numpy as np
    import torch

    from flygym_tpu_torch.compose.bridge import load_env_golden
    from flygym_tpu_torch.demo.benchmark import GOLDEN_TOLERANCE
    from flygym_tpu_torch.env import VectorFlyEnv
    from flygym_tpu_torch.olfaction import OdorField

    golden = load_env_golden()
    rec = golden["engine" if megastep is False else "emitter"]
    env = VectorFlyEnv(env_compiled, enable_vision=True, megastep=megastep,
                       odor_field=OdorField.for_compiled(env_compiled))
    step = env.make_batched_step()
    states = golden["state"].to("cuda")
    worst = {"qpos": 0.0, "qvel": 0.0, "vision_share": 1.0, "odor_rel": 0.0, "reward": 0.0}
    n_steps = golden["joints"].shape[0]
    for i in range(n_steps):
        action = {k: torch.as_tensor(golden[k][i]).cuda() for k in ("joints", "adhesion")}
        states, obs, reward, done, _ = step(states, action)
        gap = lambda a, b: float(np.abs(a.cpu().numpy() - b).max())
        worst["qpos"] = max(worst["qpos"], gap(states.qpos, rec["qpos"][i]))
        worst["qvel"] = max(worst["qvel"], gap(states.qvel, rec["qvel"][i]))
        vis = np.abs(obs["vision"].cpu().numpy() - rec["obs"]["vision"][i])
        worst["vision_share"] = min(worst["vision_share"], float((vis <= VISION_GOLDEN[0]).mean()))
        odor, odor_want = obs["odor_intensity"].cpu().numpy(), rec["obs"]["odor_intensity"][i]
        worst["odor_rel"] = max(worst["odor_rel"],
                                float((np.abs(odor - odor_want) / np.abs(odor_want)).max()))
        worst["reward"] = max(worst["reward"], gap(reward, rec["reward"][i]))
        check(bool((done.cpu().numpy() == rec["done"][i]).all()), f"{label}: done differs at {i}")
        for key, v in obs.items():
            check(bool(torch.isfinite(v).all()), f"{label}: {key} not finite at step {i}")
    print(f"[{label}] {states.qpos.shape[0]} worlds x {n_steps} env steps vs JAX: "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    for key in ("qpos", "qvel"):
        check(worst[key] <= GOLDEN_TOLERANCE[key], f"{label} {key}: {worst[key]:.3e}")
    check(worst["vision_share"] >= VISION_GOLDEN[1], f"{label} vision {worst['vision_share']}")
    check(worst["odor_rel"] <= 1e-5, f"{label} odor {worst['odor_rel']:.3e}")
    check(worst["reward"] <= 1e-6, f"{label} reward {worst['reward']:.3e}")


def terrain_inputs(terrain_compiled, model, golden, n_worlds: int, k_steps: int, seed: int):
    """The terrain golden's settled worlds repeated to ``n_worlds`` on the
    card, roots moved by up to ±20 mm and joints by 0.05 rad (seeded), the
    forward kinematics redone; the controls as a (K, B, nu) sequence with
    0.05 rad of seeded noise on the joint targets."""
    import torch

    from flygym_tpu_torch.engine.kinematics import forward_kinematics

    idx = torch.arange(n_worlds) % golden["state"].qpos.shape[0]
    state = golden["state"].map(lambda x: x[idx].clone()).to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qpos = state.qpos.clone()
    qpos[:, :2] += 40.0 * torch.rand((n_worlds, 2), generator=gen, device="cuda") - 20.0
    qpos[:, 7:] += 0.05 * torch.randn(qpos[:, 7:].shape, generator=gen, device="cuda")
    xpos, xquat = forward_kinematics(model, qpos)
    ids = torch.tensor(terrain_compiled.flies["rugged"]["act_ids"]["position"], device="cuda")
    seq = state.ctrl.expand((k_steps,) + state.ctrl.shape).clone()
    seq[:, :, ids] += 0.05 * torch.randn((k_steps, n_worlds, len(ids)), generator=gen,
                                         device="cuda")
    return replace(state, qpos=qpos, xpos=xpos, xquat=xquat, ctrl=seq[0]), seq


def phase_terrain_kernel(terrain_compiled, model) -> dict:
    """K2 with heightfield planes against its plain version; times of K2
    and of the sampler, and K2's bounds, at N_WORLDS."""
    import torch

    from flygym_tpu_torch.compose.bridge import load_terrain_golden

    golden = load_terrain_golden()

    def inputs(fn, n, k, seed):
        state, seq = terrain_inputs(terrain_compiled, model, golden, n, k, seed)
        planes = fn.sample_planes(state)
        check(bool(torch.isfinite(planes).all()), f"planes not finite at B={n}")
        return state, seq, planes

    def tilted(_state, planes):
        return f"share of tilted planes {(planes[..., 3] < 0.999).float().mean().item():.4f}"

    k2 = k2_against_plain("terrain kernel", model, inputs, tilted)
    state = inputs(k2["fns"][1], N_WORLDS, 1, 1)[0]
    k2["sample_ms"] = time_ms(lambda: k2["fns"][1].sample_planes(state), TIMED_LAUNCHES)
    print(f"[terrain kernel] plane sampler at B={N_WORLDS}: {k2['sample_ms']:.4f} ms per sample")
    return k2


def phase_terrain(terrain_compiled) -> dict:
    """Config 3 at N_WORLDS through the default step; returns the launch
    and sample counts."""
    import torch

    from flygym_tpu_torch import BatchSimulation
    from flygym_tpu_torch.demo.hybrid_terrain import HybridLoop, place_roots, root_offsets
    from flygym_tpu_torch.engine import terrain

    sim = BatchSimulation(terrain_compiled, N_WORLDS, terrain_resample=TERRAIN_RESAMPLE)
    check(sim.megastep, "config 3's default step is not the mega-step on the card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    place_roots(sim, root_offsets(N_WORLDS, gen))
    sim.set_leg_adhesion_states("rugged", torch.ones(6, device="cuda"))
    loop = HybridLoop(sim)
    cs = loop.init_state(gen)
    torch.cuda.synchronize()
    reset_counts()
    terrain.reset_samples()
    t0 = time.perf_counter()
    sim.rollout(None, TERRAIN_SETTLE_STEPS, record_trajectory=False)
    torch.cuda.synchronize()
    settle = time.perf_counter() - t0
    start_xy = sim.state.qpos[:, :2].clone()
    t0 = time.perf_counter()
    cs, _rec = loop.run(cs, TERRAIN_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {**read_counts(), "planes": terrain.samples["planes"]}
    print(f"[terrain] config 3, {N_WORLDS} worlds: settle {TERRAIN_SETTLE_STEPS} steps in "
          f"{settle:.2f} s, {TERRAIN_STEPS} closed-loop steps in {wall:.3f} s; counts {counts}")
    want = {"megastep": TERRAIN_SETTLE_STEPS // MEGASTEP_K + TERRAIN_STEPS,
            "planes": (TERRAIN_SETTLE_STEPS // MEGASTEP_K + TERRAIN_STEPS // TERRAIN_RESAMPLE),
            "tree_ldl_factor": 0, "tree_ldl_solve": 0}
    for name, n in want.items():
        check(counts[name] == n, f"terrain: {name} {counts[name]} != {n}")
    st = sim.state
    for name in ("qpos", "qvel", "qacc", "xpos", "xquat", "actuator_force", "contact_sensordata"):
        check(bool(torch.isfinite(getattr(st, name)).all()), f"terrain: state.{name} not finite")
    for name in ("phase", "amplitude"):
        check(bool(torch.isfinite(getattr(cs.cpg, name)).all()), f"terrain: cpg {name} not finite")
    z = st.qpos[:, 2]
    walked = (st.qpos[:, :2] - start_xy).norm(dim=1)
    print(f"[terrain] root z min/mean/max {z.min().item():.4f}/{z.mean().item():.4f}/"
          f"{z.max().item():.4f} mm, contact found share "
          f"{st.contact_sensordata[..., 0].mean().item():.3f}, walked mean "
          f"{walked.mean().item():.4f} mm (max {walked.max().item():.4f}) in "
          f"{TERRAIN_STEPS * terrain_compiled.model.timestep:.3f} s, retraction/stumbling "
          f"active share {(cs.retraction > 0).float().mean().item():.3f}/"
          f"{(cs.stumbling > 0).float().mean().item():.3f}")
    rate = TERRAIN_STEPS * N_WORLDS / wall
    print(f"[terrain] {wall / TERRAIN_STEPS * 1e3:.3f} ms per closed-loop step: {rate:.0f} "
          f"world-steps/s on {card_line()}")

    # The split of one step by CUDA events: controller with its readouts, K2
    # launch with its packing, and one plane sample per TERRAIN_RESAMPLE steps.
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    parts = [0.0] * 3
    state = sim.state
    for _ in range(SPLIT_STEPS):
        ev[0].record()
        planes = loop.sample_planes(state)
        ev[1].record()
        state, cs = loop.control(state, cs)
        ev[2].record()
        state = loop.physics_step(state, planes)
        ev[3].record()
        ev[3].synchronize()
        for i in range(3):
            parts[i] += ev[i].elapsed_time(ev[i + 1]) / SPLIT_STEPS
    print(f"[terrain] one closed-loop step: K2 launch with its packing {parts[2]:.3f} ms, "
          f"controller with its readouts {parts[1]:.3f} ms, plane sampling "
          f"{parts[0] / TERRAIN_RESAMPLE:.4f} ms amortised ({parts[0]:.3f} ms per sample)")
    print(f"[terrain] torch calls: controller with its readouts "
          f"{torch_calls(lambda: loop.control(state, cs))}, plane sample "
          f"{torch_calls(lambda: loop.sample_planes(state))}, K2 launch with its packing "
          f"{torch_calls(lambda: loop.physics_step(state, planes))}")
    syncs = host_syncs(
        lambda: loop.control(loop.physics_step(state, loop.sample_planes(state)), cs))
    print(f"[terrain] host synchronisations in one closed-loop step: {len(syncs)} {syncs}")
    check(not syncs, "terrain: the closed-loop step waits for the card")
    return counts


def host_syncs(fn) -> list:
    """The synchronising CUDA operations one call of ``fn`` makes (the
    first line of each of ``torch.cuda.set_sync_debug_mode``'s warnings;
    enabling the mode also warns once that it is a prototype, which is not
    one). The host runs ahead of the card only if a step never waits."""
    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [str(w.message).splitlines()[0] for w in caught
            if "called a synchronizing" in str(w.message)]


def torch_calls(fn) -> int:
    """How many torch functions and tensor methods one call of ``fn``
    dispatches (each is at least one kernel launch or host operation)."""
    from torch.overrides import TorchFunctionMode

    class Count(TorchFunctionMode):
        n = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def phase_terrain_golden(terrain_compiled, *, label: str, megastep) -> None:
    """8 worlds from the JAX settled state, 48 closed-loop steps vs a JAX path."""
    import numpy as np

    from flygym_tpu_torch import BatchSimulation
    from flygym_tpu_torch.compose.bridge import load_terrain_golden
    from flygym_tpu_torch.control import HybridState
    from flygym_tpu_torch.demo.benchmark import GOLDEN_TOLERANCE
    from flygym_tpu_torch.demo.hybrid_terrain import HybridLoop

    golden = load_terrain_golden()
    rec_want = golden["engine" if megastep is False else "emitter"]
    n_worlds = golden["state"].qpos.shape[0]
    sim = BatchSimulation(terrain_compiled, n_worlds, megastep=megastep,
                          terrain_resample=golden["meta"]["terrain_resample"])
    check(sim.megastep == (megastep is not False), f"{label}: wrong step")
    sim.state = golden["state"].to("cuda")
    loop = HybridLoop(sim)
    cs = HybridState.from_numpy(golden["controller"], device="cuda")
    n_steps = rec_want["qpos"].shape[0]
    cs, rec = loop.run(cs, n_steps, record=True)
    worst = {key: float(np.abs(rec[key].cpu().numpy() - rec_want[key]).max())
             for key in ("qpos", "qvel")}
    found = rec["sensordata"][..., 0].cpu().numpy() != rec_want["sensordata"][..., 0]
    worst["found_share"] = float(found.mean())
    phase_gap = float(np.abs(cs.cpg.phase.cpu().numpy()
                             - rec_want["controller"]["phase"]).max())
    print(f"[{label}] {n_worlds} worlds x {n_steps} closed-loop steps vs JAX: max|dqpos| "
          f"{worst['qpos']:.3e}, max|dqvel| {worst['qvel']:.3e}, share of found flags "
          f"differing {worst['found_share']:.4f}, max|dphase| {phase_gap:.3e}; "
          f"tolerances {GOLDEN_TOLERANCE}")
    for key, tol in GOLDEN_TOLERANCE.items():
        check(worst[key] <= tol, f"{label} {key}: {worst[key]:.3e} > {tol}")
    if megastep is not False:
        # The K2 path repeats the JAX emitter's loop to the last bit since the
        # controller divides as JAX does on the card too (PERF.md §6).
        check(worst == {"qpos": 0.0, "qvel": 0.0, "found_share": 0.0} and phase_gap == 0.0,
              f"{label}: gaps {worst}, phase {phase_gap:.3e}; the K2 path must repeat JAX")


def jitter(model, state, seed: int, qvel_scale: float = 0.0):
    """``state`` on the card with every root moved by up to ±0.05 mm in xy
    and every hinge by 0.01 rad, and with ``qvel_scale`` qvel by that much
    (seeded normal noise), the forward kinematics redone: worlds that
    differ from each other, so that a world reading another's rows shows."""
    import torch

    from flygym_tpu_torch.engine.kinematics import forward_kinematics

    n_worlds = state.qpos.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qpos = state.qpos.clone()
    for _body, qadr, _vadr in model.free_joints:
        qpos[:, qadr:qadr + 2] += 0.1 * torch.rand((n_worlds, 2), generator=gen,
                                                   device="cuda") - 0.05
    hinges = model.hinge_qadr
    qpos[:, hinges] += 0.01 * torch.randn((n_worlds, len(hinges)), generator=gen,
                                          device="cuda")
    qvel = state.qvel
    if qvel_scale:
        qvel = qvel + qvel_scale * torch.randn(qvel.shape, generator=gen, device="cuda")
    xpos, xquat = forward_kinematics(model, qpos)
    return replace(state, qpos=qpos, qvel=qvel, xpos=xpos, xquat=xquat)


def twofly_inputs(model, golden, n_worlds: int, k_steps: int, seed: int):
    """The two-fly golden's settled worlds repeated to ``n_worlds`` on the
    card and moved by ``jitter``; the controls (adhesion on the bottom fly)
    as a (K, B, nu) sequence."""
    import torch

    idx = torch.arange(n_worlds) % golden["state"].qpos.shape[0]
    state = jitter(model, golden["state"].map(lambda x: x[idx].clone()).to("cuda"), seed)
    seq = state.ctrl.expand((k_steps,) + state.ctrl.shape).clone()
    return replace(state, ctrl=seq[0]), seq


def active_pair_share(model, state) -> float:
    """The share of worlds in which at least one pair row is closer than its
    margin, at the state's cached pose."""
    from flygym_tpu_torch.engine.contact import contact_candidates
    from flygym_tpu_torch.engine.kinematics import geom_poses

    gpos, gquat = geom_poses(model, state.xpos, state.xquat)
    dist = contact_candidates(model, gpos, gquat)[0]
    ng = model.ncand - model.ncand_pair
    return (dist[:, ng:] < model.can_margin[ng:]).any(dim=1).float().mean().item()


def phase_pairs_kernel(model) -> dict:
    """K2 with fly-fly pair rows against its plain version; times of K2 and
    its bounds at N_WORLDS."""
    from flygym_tpu_torch.compose.bridge import load_twofly_golden

    golden = load_twofly_golden()
    return k2_against_plain(
        "pairs kernel", model,
        lambda fn, n, k, seed: (*twofly_inputs(model, golden, n, k, seed), None),
        lambda state, _planes: f"worlds with an active pair row "
                               f"{active_pair_share(model, state):.4f}",
        checks=((N_WORLDS, 1), (N_WORLDS, MEGASTEP_K)))


def compressed_inputs(model, golden, n_worlds: int, k_steps: int, seed: int, fn):
    """``twofly_inputs`` of a compressed golden, with the winners the port's
    sampler gives under the noisy pose."""
    import torch

    state, seq = twofly_inputs(model, golden, n_worlds, k_steps, seed)
    widx = fn.sample_planes(state)
    check(bool(torch.isfinite(widx).all()), f"winners not finite at B={n_worlds}")
    return state, seq, widx


def phase_compressed_kernel(full_model, pile_model) -> dict:
    """K2 with compressed pair rows against its plain version on the
    default two-fly preset and the 3-fly pile; times of K2 and its bounds
    at N_WORLDS (the pile's kernel only), and of the winner sampler (the
    default preset).

    The plain version of the 55 x 55 preset takes ~12-17 s per step
    whatever the worlds, so it is held at 4096 worlds only: K = 8 is the
    main path's launch, whose plain time the kernels line needs."""
    from flygym_tpu_torch.compose.bridge import (
        THREEFLY_GOLDEN, TWOFLY_FULL_GOLDEN, load_twofly_golden)

    out = {}
    for label, model, path, checks, timed in (
        ("compressed kernel", full_model, TWOFLY_FULL_GOLDEN,
         ((N_WORLDS, 1), (N_WORLDS, MEGASTEP_K)), True),
        ("compressed kernel, 3-fly pile", pile_model, THREEFLY_GOLDEN,
         ((1000, 1), (1000, PILE_CHECK_K)), True),
    ):
        golden = load_twofly_golden(path)
        out[label] = k2_against_plain(
            label, model,
            lambda fn, n, k, seed, model=model, golden=golden: compressed_inputs(
                model, golden, n, k, seed, fn),
            lambda state, _w, model=model: f"worlds with an active compressed row "
                                           f"{active_pair_share(model, state):.4f}",
            checks=checks, timed=timed)
    k2 = out["compressed kernel"]
    state = twofly_inputs(full_model, load_twofly_golden(TWOFLY_FULL_GOLDEN), N_WORLDS, 1, 1)[0]
    k2["sample_ms"] = time_ms(lambda: k2["fns"][1].sample_planes(state), TIMED_LAUNCHES)
    print(f"[compressed kernel] winner sampler at B={N_WORLDS}: {k2['sample_ms']:.4f} ms "
          f"per sample")
    return k2


def phase_twofly(twofly_compiled, label="twofly", what="example 11", rest_mm=REST_GAP_MM,
                 slide_off_mm=None, engine_steps=TWOFLY_ENGINE_STEPS):
    """Two stacked flies at N_WORLDS through the default step, then the
    engine path from the same drop; returns the mega path's counts
    (launches, winner samples) and its walltime. The top fly must rest on
    the bottom one in every world or, with ``slide_off_mm``, have slid off
    it: its root that far from the bottom one's in xy. It must never sink
    into the bottom fly."""
    import torch

    from flygym_tpu_torch import BatchSimulation
    from flygym_tpu_torch.demo.hybrid_terrain import place_roots
    from flygym_tpu_torch.engine import contact

    sim = BatchSimulation(twofly_compiled, N_WORLDS)
    check(sim.megastep, f"{what}'s default step is not the mega-step on the card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    offsets = (2.0 * torch.rand((N_WORLDS, 2), generator=gen, device="cuda") - 1.0) * TOP_OFFSET_MM
    place_roots(sim, offsets, root=1)
    sim.set_leg_adhesion_states("bottom", torch.ones(6, device="cuda"))
    drop = sim.state
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    sim.rollout(None, TWOFLY_STEPS, record_trajectory=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    print(f"[{label}] {what}, {N_WORLDS} worlds: {TWOFLY_STEPS} steps in {wall:.3f} s; "
          f"counts {counts}")
    compressed = sim.model.pair_compress
    want = {"megastep": TWOFLY_STEPS // MEGASTEP_K, "tree_ldl_factor": 0, "tree_ldl_solve": 0,
            "winners": TWOFLY_STEPS // MEGASTEP_K if compressed else 0}
    for name, n in want.items():
        check(counts[name] == n, f"{label}: {name} {counts[name]} != {n}")
    st = sim.state
    for name in ("qpos", "qvel", "qacc", "xpos", "xquat", "actuator_force", "contact_sensordata"):
        check(bool(torch.isfinite(getattr(st, name)).all()), f"{label}: state.{name} not finite")
    (_b0, q_bottom, _v0), (_b1, q_top, _v1) = sim.model.free_joints
    lift = st.qpos[:, q_top + 2] - st.qpos[:, q_bottom + 2]
    share = active_pair_share(sim.model, st)
    rows = "compressed row (its group's winner)" if compressed else "pair row"
    print(f"[{label}] top root z above the bottom's: min/mean/max {lift.min().item():.4f}/"
          f"{lift.mean().item():.4f}/{lift.max().item():.4f} mm; worlds with an active {rows} "
          f"{share:.4f}; max|qvel| {st.qvel.abs().max().item():.2f}; worlds passing example "
          f"11's check (more than {REST_GAP_MM} mm) {(lift > REST_GAP_MM).float().mean().item():.4f}")
    low = lift <= rest_mm
    if slide_off_mm is not None:
        sep = (st.qpos[:, q_top:q_top + 2] - st.qpos[:, q_bottom:q_bottom + 2]).norm(dim=1)
        off = low & (sep >= slide_off_mm)
        print(f"[{label}] worlds whose top fly slid off the bottom one (root z less than "
              f"{rest_mm} mm above it, {slide_off_mm} mm or more away in xy): "
              f"{int(off.sum().item())} ({off.float().mean().item():.4f}); their xy "
              f"distance min {sep[off].min().item() if off.any() else float('nan'):.3f} mm; "
              f"lower worlds closer than that: {int((low & ~off).sum().item())}"
              + (f", xy distance {sep[low & ~off].tolist()[:8]}" if (low & ~off).any() else ""))
        low = low & ~off
    check(not bool(low.any()), f"{label}: the top fly sinks into the bottom one "
          f"in {int(low.sum().item())} worlds")
    check(share > 0.0, f"{label}: no world has an active pair row")
    rate = TWOFLY_STEPS * N_WORLDS / wall
    print(f"[{label}] {wall / TWOFLY_STEPS * 1e3:.3f} ms per step: {rate:.0f} world-steps/s "
          f"(both flies) on {card_line()}")

    esim = BatchSimulation(twofly_compiled, N_WORLDS, megastep=False)
    esim.state = drop
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    esim.rollout(None, engine_steps, record_trajectory=False)
    torch.cuda.synchronize()
    ewall = time.perf_counter() - t0
    ecounts = read_counts()
    print(f"[{label} engine] {N_WORLDS} worlds, {engine_steps} steps from the drop in "
          f"{ewall:.3f} s ({ewall / engine_steps * 1e3:.3f} ms per step); counts "
          f"{ecounts}")
    want = {"megastep": 0, "tree_ldl_factor": engine_steps,
            "tree_ldl_solve": 2 * engine_steps, "winners": 0}
    for name, n in want.items():
        check(ecounts[name] == n, f"{label} engine: {name} {ecounts[name]} != {n}")
    for name in ("qpos", "qvel", "qacc", "xpos", "contact_sensordata"):
        check(bool(torch.isfinite(getattr(esim.state, name)).all()),
              f"{label} engine: state.{name} not finite")
    return counts, wall


def golden_aux(sim, golden, i: int, label: str):
    """What step ``i`` of a two-fly golden's K2 path reads from outside the
    kernel, as the JAX emitter was fed it: the stored winners of a
    compressed golden, on a heightfield world the stored planes (flattened)
    before them, one sample per ``meta["winner_k"]`` (``aux_k``) steps;
    None for a golden without. At each chunk's first step the port's
    samplers on the state must give them: the planes within PLANE_ATOL and
    the winners but for groups whose two nearest members lie within
    NEAR_TIE_MM (the winner sampler's distances equal JAX's to the last bit
    on the CPU, tests/test_torch_compress.py)."""
    import torch

    from flygym_tpu_torch.ops import megastep

    rec, meta = golden["emitter"], golden["meta"]
    if "widx" not in rec:
        return None
    k = meta.get("winner_k", meta.get("aux_k"))
    widx = torch.as_tensor(rec["widx"][i // k]).cuda()
    planes = torch.as_tensor(rec["planes"][i // k]).cuda() if "planes" in rec else None
    if i % k == 0:
        st = megastep._Static(sim.model)
        got_planes, _w = megastep._split_aux(st, megastep._aux_sampler(sim.model, st)(
            sim.state.xpos, sim.state.xquat))
        gap = 0.0 if planes is None else (got_planes - planes).abs().max().item()
        differ, ties = winners_near_tie(sim.model, sim.state, widx, label, i)
        print(f"[{label}] step {i}: the port's samplers against the stored samples: "
              + ("" if planes is None else f"planes max gap {gap:.3e}, ")
              + f"{differ} of {widx.numel()} winners differ, {ties} groups within "
                f"{NEAR_TIE_MM} mm of a tie")
        check(gap <= PLANE_ATOL, f"{label}: the port's planes part by {gap:.3e} at step {i}")
    if planes is None:
        return widx
    return torch.cat([planes.reshape(planes.shape[0], -1), widx], dim=1)


def winners_near_tie(model, state, widx, label: str, i: int) -> tuple:
    """The port's winners at ``state`` against ``widx``: they may part only
    in groups whose two nearest members lie within NEAR_TIE_MM. Returns the
    number of groups that part and of those near a tie."""
    import torch

    from flygym_tpu_torch.engine import contact

    sampler = contact.make_pair_winner_sampler(model)
    got = sampler(state.xpos, state.xquat)
    dist = sampler.distances(state.xpos, state.xquat)
    _start, idx, pad = contact._group_table(tuple(model.pair_groups), dist.device)
    two = torch.sort(dist[:, idx] + pad, dim=-1).values[..., :2]
    tie = (two[..., 1] - two[..., 0]) <= NEAR_TIE_MM
    differ = got != widx
    check(bool((~differ | tie).all()), f"{label}: the port's winners differ at step {i}")
    return int(differ.sum().item()), int(tie.sum().item())


def phase_twofly_golden(twofly_compiled, *, label: str, megastep, golden_path=None) -> None:
    """8 worlds from the JAX settled state, 16 steps vs a JAX path: the K2
    path to GOLDEN_TOLERANCE (on a compressed world with the JAX emitter's
    stored winners, on a heightfield world with its stored planes too:
    ``golden_aux``), the engine path within the probe's bar."""
    import numpy as np

    from flygym_tpu_torch import BatchSimulation
    from flygym_tpu_torch.compose.bridge import TWOFLY_GOLDEN, load_twofly_golden
    from flygym_tpu_torch.demo.benchmark import GOLDEN_TOLERANCE

    golden = load_twofly_golden(golden_path or TWOFLY_GOLDEN)
    engine = megastep is False
    rec, probe = golden["engine" if engine else "emitter"], golden["probe"]
    n_worlds = golden["state"].qpos.shape[0]
    sim = BatchSimulation(twofly_compiled, n_worlds, megastep=megastep, megastep_k=1)
    check(sim.megastep == (not engine), f"{label}: wrong step")
    sim.state = golden["state"].to("cuda")
    fn = None if engine else sim.step_fns(1)[0]
    worst = {"qpos": 0.0, "qvel": 0.0, "found_share": 0.0}
    ratio = {"qpos": 0.0, "qvel": 0.0}
    n_steps = rec["qpos"].shape[0]
    for i in range(n_steps):
        aux = None if engine else golden_aux(sim, golden, i, label)
        if aux is None:
            sim.rollout(None, 1, record_trajectory=False)
        else:
            sim.shards = fn(sim.shards, [aux])
        for key in ("qpos", "qvel"):
            got = getattr(sim.state, key).cpu().numpy()
            gap = float(np.abs(got - rec[key][i]).max())
            worst[key] = max(worst[key], gap)
            if engine:
                bar = max(3.0 * float(np.abs(probe[key][i] - rec[key][i]).max()), PROBE_FLOOR[key])
                ratio[key] = max(ratio[key], gap / bar)
                check(gap <= bar, f"{label} {key} at step {i}: {gap:.3e} > {bar:.3e}")
        found = sim.state.contact_sensordata[..., 0].cpu().numpy() != rec["sensordata"][i][..., 0]
        worst["found_share"] += float(found.mean()) / n_steps
    print(f"[{label}] {n_worlds} worlds x {n_steps} steps vs JAX: max|dqpos| "
          f"{worst['qpos']:.3e}, max|dqvel| {worst['qvel']:.3e}, share of found flags "
          f"differing {worst['found_share']:.4f}"
          + (f"; largest gap / probe bar qpos {ratio['qpos']:.3f}, qvel {ratio['qvel']:.3f}"
             if engine else f"; tolerances {GOLDEN_TOLERANCE}"))
    if not engine:
        for key, tol in GOLDEN_TOLERANCE.items():
            check(worst[key] <= tol, f"{label} {key}: {worst[key]:.3e} > {tol}")


def actuator_inputs(model, golden, n_worlds: int, k_steps: int, seed: int):
    """The settled worlds of a golden of ``scripts/export_actuator_golden.py``
    repeated to ``n_worlds`` on the card, joints moved by 0.01 rad and the
    activations drawn uniform in [0, 1] (seeded), the forward kinematics
    redone; the golden's first ``k_steps`` controls as a (K, B, nu)
    sequence."""
    import torch

    from flygym_tpu_torch.engine.kinematics import forward_kinematics

    n_golden = golden["state"].qpos.shape[0]
    idx = torch.arange(n_worlds) % n_golden
    state = golden["state"].map(lambda x: x[idx].clone()).to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qpos = state.qpos.clone()
    hinges = model.hinge_qadr
    qpos[:, hinges] += 0.01 * torch.randn((n_worlds, len(hinges)), generator=gen, device="cuda")
    xpos, xquat = forward_kinematics(model, qpos)
    act = torch.rand(state.act.shape, generator=gen, device="cuda")
    seq = torch.as_tensor(golden["ctrl"][:k_steps])[:, idx].cuda()
    return replace(state, qpos=qpos, xpos=xpos, xquat=xquat, act=act, ctrl=seq[0]), seq


def phase_strict_kernel(model) -> dict:
    """K2 with the exact Newton against its plain version; times and bounds
    at N_WORLDS. The plain strict step takes ~13 s on the card whatever the
    worlds, so K = 1 is held at 1000 worlds and K = 8 at 4096 only."""
    from flygym_tpu_torch.compose.bridge import STRICT_GOLDEN, load_actuator_golden

    golden = load_actuator_golden(STRICT_GOLDEN)
    return k2_against_plain(
        "strict kernel", model,
        lambda fn, n, k, seed: (*actuator_inputs(model, golden, n, k, seed), None),
        checks=((1000, 1), (N_WORLDS, MEGASTEP_K)))


def phase_actuator_kernels(muscle_model, mixed_model) -> dict:
    """K2 with every actuator kind and activation states against its plain
    version, for the muscle fly and the mixed-kind fly: K = 1 held at 1000
    worlds and K = 8 at N_WORLDS, as the strict fly; times and bounds at
    N_WORLDS."""
    from flygym_tpu_torch.compose.bridge import (
        MIXED_GOLDEN, MUSCLE_GOLDEN, load_actuator_golden)

    out = {}
    for label, model, path in (("muscle kernel", muscle_model, MUSCLE_GOLDEN),
                               ("mixed kernel", mixed_model, MIXED_GOLDEN)):
        golden = load_actuator_golden(path)
        out[label] = k2_against_plain(
            label, model,
            lambda fn, n, k, seed, model=model, golden=golden: (
                *actuator_inputs(model, golden, n, k, seed), None),
            lambda state, _p: f"activations in [{state.act.min().item():.3f}, "
                              f"{state.act.max().item():.3f}]",
            checks=((1000, 1), (N_WORLDS, MEGASTEP_K)))
    return out


def phase_actuated_rollout(compiled, *, label: str, n_steps: int, ctrl_fn) -> tuple:
    """``compiled``'s fly at N_WORLDS through the default step from the
    drop: adhesion on where the fly has it, ``ctrl_fn(sim, fly, gen)`` sets
    the actuators' inputs, then a timed ``rollout(None, n_steps)``; returns
    the counts, the walltime and the simulation."""
    import torch

    from flygym_tpu_torch import BatchSimulation

    sim = BatchSimulation(compiled, N_WORLDS)
    check(sim.megastep, f"{label}: the default step is not the mega-step on the card")
    fly = compiled.fly_names[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    if compiled.flies[fly]["adh_ids"]:
        sim.set_leg_adhesion_states(fly, torch.ones(6, device="cuda"))
    ctrl_fn(sim, fly, gen)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    sim.rollout(None, n_steps, record_trajectory=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    print(f"[{label}] {N_WORLDS} worlds: {n_steps} steps in {wall:.3f} s; counts {counts}")
    want = {"megastep": n_steps // MEGASTEP_K, "tree_ldl_factor": 0, "tree_ldl_solve": 0}
    for name, n in want.items():
        check(counts[name] == n, f"{label}: {name} {counts[name]} != {n}")
    st = sim.state
    for name in ("qpos", "qvel", "qacc", "act", "xpos", "xquat", "actuator_force",
                 "contact_sensordata"):
        check(bool(torch.isfinite(getattr(st, name)).all()), f"{label}: state.{name} not finite")
    check(abs(sim.time - n_steps * compiled.model.timestep) < 1e-3, f"{label}: time {sim.time}")
    words = [f"max|qvel| {st.qvel.abs().max().item():.2f}"]
    if compiled.model.free_joints:
        z = st.qpos[:, 2]
        words.append(f"root z min/mean/max {z.min().item():.4f}/{z.mean().item():.4f}/"
                     f"{z.max().item():.4f} mm")
    if st.contact_sensordata.numel():
        words.append(f"contact found share {st.contact_sensordata[..., 0].mean().item():.3f}")
    if st.act.numel():
        words.append(f"activations in [{st.act.min().item():.4f}, {st.act.max().item():.4f}]")
    print(f"[{label}] " + ", ".join(words))
    rate = n_steps * N_WORLDS / wall
    print(f"[{label}] {wall / n_steps * 1e3:.3f} ms per step: {rate:.0f} world-steps/s on "
          f"{card_line()}")
    return counts, wall, sim


def phase_muscle(muscle_compiled) -> tuple:
    """The muscle-driven fly at N_WORLDS: each world's muscles hold a seeded
    uniform draw in MUSCLE_CTRL."""
    import torch

    def muscles(sim, fly, gen):
        n = len(sim.actuated_dofs(fly, "muscle"))
        lo, hi = MUSCLE_CTRL
        sim.set_actuator_inputs(
            fly, "muscle", lo + (hi - lo) * torch.rand((N_WORLDS, n), generator=gen, device="cuda"))

    counts, wall, sim = phase_actuated_rollout(muscle_compiled, label="muscle", n_steps=MUSCLE_STEPS,
                                               ctrl_fn=muscles)
    act = sim.state.act
    check(bool(((act >= 0.0) & (act <= 1.0)).all()), "muscle: an activation outside [0, 1]")
    return counts, wall


def phase_mixed(mixed_compiled) -> dict:
    """The mixed-kind fly at N_WORLDS: world w holds the controls of the
    mixed golden's world w mod 8, set kind by kind by name."""
    import torch

    from flygym_tpu_torch.compose.bridge import MIXED_GOLDEN, load_actuator_golden

    golden = load_actuator_golden(MIXED_GOLDEN)

    def kinds(sim, fly, _gen):
        ctrl = torch.as_tensor(golden["ctrl"][0], device="cuda")
        idx = torch.arange(N_WORLDS, device="cuda") % ctrl.shape[0]
        for kind in sim.compiled.flies[fly]["act_ids"]:
            if kind != "adhesion":
                sim.set_actuator_inputs(fly, kind, ctrl[idx][:, sim.actuator_ids(fly, kind)])

    counts, _wall, _sim = phase_actuated_rollout(mixed_compiled, label="mixed", n_steps=MIXED_STEPS,
                                                 ctrl_fn=kinds)
    return counts


def phase_actuator_golden(compiled, golden_path, *, label: str) -> None:
    """8 worlds from the JAX settled state, 50 steps of the golden's
    controls: the K2 path against the JAX emitter with 0 gaps; the engine
    path against the JAX engine at each step within GOLDEN_TOLERANCE or, where
    the golden's conditioning probe spreads wider (the mixed fly's ringing
    legs), 3 times the probe's spread, as phase 15 holds the stacked flies,
    at the steps where that bar is GOLDEN_TOLERANCE or at most
    PROBE_BAR_SHARE of the state's largest value; the activations within
    ACT_ATOL at every step."""
    import numpy as np

    from flygym_tpu_torch.compose.bridge import load_actuator_golden
    from flygym_tpu_torch.demo.benchmark import GOLDEN_TOLERANCE, track_controls

    golden = load_actuator_golden(golden_path)
    n_steps, n_worlds = golden["ctrl"].shape[:2]
    for path, megastep, record in (("megastep", None, "emitter"), ("engine", False, "engine")):
        gaps = track_controls(compiled, golden, record, device="cuda", megastep=megastep)
        worst = {key: float(np.max(gap)) for key, gap in gaps.items()}
        line = (f"[{label} golden {path}] {n_worlds} worlds x {n_steps} steps vs JAX {record}: "
                + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
        if megastep is None:
            print(line)
            for key, gap in worst.items():
                check(gap == 0.0, f"{label} golden {path}: {key} {gap:.3e} != 0")
            continue
        ratios = []
        for key in ("qpos", "qvel"):
            spread = np.abs(golden["probe"][key] - golden["engine"][key]).reshape(n_steps, -1)
            size = np.abs(golden["engine"][key]).reshape(n_steps, -1).max(axis=1)
            tol = GOLDEN_TOLERANCE[key]
            bar = np.maximum(tol, 3.0 * spread.max(axis=1))
            held = np.flatnonzero((bar <= tol) | (bar <= PROBE_BAR_SHARE * size))
            check(len(held) > 0, f"{label} golden {path} {key}: no step held")
            free = np.setdiff1d(np.arange(n_steps), held)
            ratios.append(f"{key} {float(np.max(gaps[key][held] / bar[held])):.3f} over "
                          f"{len(held)} steps held (first not held: "
                          f"{int(free[0]) if len(free) else None}; largest gap held "
                          f"{float(np.max(gaps[key][held])):.3e})")
            bad = held[gaps[key][held] > bar[held]]
            check(not len(bad), f"{label} golden {path} {key} at step {bad[:1]}: "
                                f"{gaps[key][bad[:1]]} > {bar[bad[:1]]}")
        print(line + f"; largest gap / bar {'; '.join(ratios)} (bar: GOLDEN_TOLERANCE or 3x "
                     f"the probe's spread, held where at most GOLDEN_TOLERANCE or "
                     f"{PROBE_BAR_SHARE} of max|JAX engine|)")
        check(worst["found_share"] <= GOLDEN_TOLERANCE["found_share"],
              f"{label} golden {path} found_share {worst['found_share']:.3e}")
        check(worst["act"] <= ACT_ATOL, f"{label} golden {path} act: {worst['act']:.3e}")

def phase_tethered_kernel(model) -> dict:
    """K2 built for the tethered motor fly (no contact candidate: qacc from
    the tree solve of Mh) against its plain version: K = 1 at 1000 worlds
    and K = 8 at N_WORLDS from the tethered golden's settled worlds with
    seeded joint noise; times and bounds at N_WORLDS."""
    from flygym_tpu_torch.compose.bridge import TETHERED_GOLDEN, load_actuator_golden

    golden = load_actuator_golden(TETHERED_GOLDEN)
    return k2_against_plain(
        "tethered kernel", model,
        lambda fn, n, k, seed: (*actuator_inputs(model, golden, n, k, seed), None),
        checks=((1000, 1), (N_WORLDS, MEGASTEP_K)))


def tethered_torques(sim, fly, gen) -> None:
    """Each world's motors hold a seeded uniform torque inside their
    forcerange (-TETHER_TORQUE, TETHER_TORQUE)."""
    import torch

    n = len(sim.actuated_dofs(fly, "motor"))
    torque = TETHER_TORQUE * (2.0 * torch.rand((sim.n_worlds, n), generator=gen,
                                               device="cuda") - 1.0)
    sim.set_actuator_inputs(fly, "motor", torque)


def phase_single_world(compiled, tethered_compiled) -> dict:
    """The single-world API on the card (B = 1): the benchmark fly with
    adhesion on, ``warmup()`` (500 K = 1 launches), SINGLE_STEPS
    ``step_with_profile()`` calls (one K2 launch each, no K1/K1b), their
    state equal to the last bit to a ``megastep_k=1`` ``rollout`` from the
    same state; the performance report, ms per step and the realtime factor;
    a ``save_state`` / ``load_state`` round trip equal to the last bit, and
    10 more steps of both equal; then TETHERED_SINGLE_STEPS ``step()`` calls
    of the tethered fly."""
    import tempfile

    import torch

    from flygym_tpu_torch import Simulation

    fields = ("qpos", "qvel", "ctrl", "act", "time", "qacc", "xpos", "xquat", "site_xpos",
              "actuator_force", "contact_sensordata")

    def same(a, b) -> bool:
        return all(torch.equal(getattr(a, f), getattr(b, f)) for f in fields)

    fly = compiled.fly_names[0]
    sim = Simulation(compiled)
    check(sim.megastep, "single world: the default step is not the mega-step on the card")
    sim.set_leg_adhesion_states(fly, torch.ones(6, device="cuda"))
    reset_counts()
    sim.warmup()
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"[single world] warmup(): {counts}")
    check(counts["megastep"] == SETTLE_STEPS and counts["tree_ldl_factor"] == 0
          and counts["tree_ldl_solve"] == 0, f"single world warmup: launches {counts}")
    start = sim.state
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(SINGLE_STEPS):
        sim.step_with_profile()
    wall = time.perf_counter() - t0
    counts = read_counts()
    print(f"[single world] {SINGLE_STEPS} step_with_profile() calls in {wall:.3f} s; "
          f"counts {counts}")
    check(counts["megastep"] == SINGLE_STEPS and counts["tree_ldl_factor"] == 0
          and counts["tree_ldl_solve"] == 0, f"single world steps: launches {counts}")
    check(sim._curr_step == SINGLE_STEPS, f"single world: {sim._curr_step} steps counted")
    ref = Simulation(compiled, megastep_k=1)
    ref.state = start
    ref.rollout(None, SINGLE_STEPS, record_trajectory=False)
    check(same(sim.state, ref.state), "single world: step() differs from rollout(megastep_k=1)")
    check(all(bool(torch.isfinite(getattr(sim.state, f)).all()) for f in fields),
          "single world: state not finite")
    sim.print_performance_report()
    ms_step = sim._total_physics_time_ns / sim._curr_step / 1e6
    print(f"[single world] B=1, step_with_profile: {ms_step:.4f} ms per step, realtime factor "
          f"{sim.timestep / (ms_step * 1e-3):.4f}, {1e3 / ms_step:.0f} steps/s; equal to the "
          f"K = 1 rollout to the last bit: True; on {card_line()}")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "state.npz"
        sim.save_state(path)
        back = Simulation(compiled)
        back.load_state(path)
    check(same(back.state, sim.state), "single world: load_state(save_state()) differs")
    for _ in range(10):
        sim.step()
        back.step()
    check(same(back.state, sim.state), "single world: 10 steps after load_state differ")
    print("[single world] save_state -> load_state equal to the last bit, and 10 steps after: "
          "True")

    tfly = tethered_compiled.fly_names[0]
    teth = Simulation(tethered_compiled)
    check(teth.megastep, "tethered single world: the default step is not the mega-step")
    tethered_torques(teth, tfly, torch.Generator(device="cuda").manual_seed(1))
    start = teth.state
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(TETHERED_SINGLE_STEPS):
        teth.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    check(counts["megastep"] == TETHERED_SINGLE_STEPS and counts["tree_ldl_factor"] == 0,
          f"tethered single world: launches {counts}")
    ref = Simulation(tethered_compiled, megastep_k=1)
    ref.state = start
    ref.rollout(None, TETHERED_SINGLE_STEPS, record_trajectory=False)
    check(same(teth.state, ref.state), "tethered single world: step() differs from rollout")
    check(bool(torch.isfinite(teth.state.qvel).all()), "tethered single world: qvel not finite")
    print(f"[single world] tethered fly: {TETHERED_SINGLE_STEPS} step() calls in {wall:.3f} s "
          f"({wall / TETHERED_SINGLE_STEPS * 1e3:.4f} ms per step), launches {counts}, equal "
          f"to the K = 1 rollout: True, max|qvel| {teth.state.qvel.abs().max().item():.3f}")
    return {"ms_step": ms_step}


def phase_sweep() -> dict:
    """``run_benchmark`` over SWEEP_COUNTS on the card at SWEEP_SETTLE and
    SWEEP_STEPS, each count's run_simulation checked (its K2 launches, no
    K1/K1b, all state finite);
    then ``python -m flygym_tpu_torch.demo.benchmark`` at N_WORLDS as a
    subprocess, whose last line must be bench.py's JSON with a value > 0."""
    import torch

    from flygym_tpu_torch.demo import benchmark

    run = benchmark.run_simulation
    want = SWEEP_SETTLE + 2 * (SWEEP_STEPS // MEGASTEP_K)

    def checked(compiled, targets, **kwargs):
        reset_counts()
        walltime, sim = run(compiled, targets, **kwargs)
        counts = read_counts()
        n = targets.shape[0]
        check(counts["megastep"] == want and counts["tree_ldl_factor"] == 0
              and counts["tree_ldl_solve"] == 0, f"sweep at {n} worlds: launches {counts}")
        for name in ("qpos", "qvel", "qacc", "xpos", "xquat", "contact_sensordata"):
            check(bool(torch.isfinite(getattr(sim.state, name)).all()),
                  f"sweep at {n} worlds: state.{name} not finite")
        return walltime, sim

    lo, hi, factor = SWEEP_COUNTS
    benchmark.run_simulation = checked
    try:
        cols = benchmark.run_benchmark(lo, hi, factor, sim_steps=SWEEP_STEPS,
                                       warmup_steps=SWEEP_SETTLE)
    finally:
        benchmark.run_simulation = run
    counts = cols["n_worlds"].tolist()
    expected = []
    n = lo
    while n <= hi:
        expected.append(n)
        n *= factor
    check(counts == expected, f"sweep: ran {counts}, not {expected}")
    print(f"[sweep] {'n_worlds':>8} {'walltime_s':>11} {'world-steps/s':>14} {'x realtime':>11}")
    for n, w, r, x in zip(counts, cols["walltime_s"], cols["steps_per_second"],
                          cols["realtime_factor"]):
        print(f"[sweep] {n:>8} {w:>11.4f} {r:>14.0f} {x:>11.2f}")
    print(f"[sweep] each count: {want} K2 launches, no K1/K1b, state finite; on {card_line()}")
    proc = subprocess.run(
        [sys.executable, "-m", "flygym_tpu_torch.demo.benchmark", str(N_WORLDS)],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True, timeout=600)
    print(f"[sweep] python -m flygym_tpu_torch.demo.benchmark {N_WORLDS}: exit "
          f"{proc.returncode}; stderr: {proc.stderr.strip()[-500:]}")
    check(proc.returncode == 0, "the benchmark entry failed")
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"[sweep] its last line: {json.dumps(last)}")
    check(set(last) == {"metric", "value", "unit", "vs_baseline"} and last["value"] > 0
          and last["unit"] == "world-steps/s", f"the benchmark entry's line {last}")
    return cols


def phase_trace(compiled) -> dict:
    """One ``utils.profiling.trace()`` of TRACE_LAUNCHES K = 8 launches of
    the replay at N_WORLDS, after one untimed run of the same: the card's
    busy share and its top device op, which must be K2's kernel."""
    import numpy as np
    import torch

    from flygym_tpu_torch import BatchSimulation
    from flygym_tpu_torch.demo.benchmark import ReplayTargetData, replay_episode
    from flygym_tpu_torch.utils.profiling import summarize_trace, trace

    fly = compiled.fly_names[0]
    n_steps = TRACE_LAUNCHES * MEGASTEP_K
    dof_order = [tuple(d) for d in compiled.flies[fly]["actuated_dofs"]["position"]]
    targets = torch.as_tensor(ReplayTargetData(compiled.model.timestep, dof_order)
                              .make_target_angles_all_worlds(N_WORLDS, n_steps), device="cuda")
    sim = BatchSimulation(compiled, N_WORLDS)
    sim.set_leg_adhesion_states(fly, np.ones((N_WORLDS, 6), np.float32))
    act_ids = sim.actuator_ids(fly, "position")
    shards = replay_episode(sim, sim.shards, targets, act_ids, n_steps)
    torch.cuda.synchronize()
    reset_counts()
    logdir = Path(__file__).resolve().parent / "outputs" / "trace"
    with trace(str(logdir), summarize=False):
        replay_episode(sim, shards, targets, act_ids, n_steps)
        torch.cuda.synchronize()
    counts = read_counts()
    check(counts["megastep"] == TRACE_LAUNCHES, f"trace: launches {counts}")
    digest = summarize_trace(str(logdir))
    check(digest is not None and digest["top_device_ops"], "trace: no device op recorded")
    top = digest["top_device_ops"][0]
    print(f"[trace] {TRACE_LAUNCHES} K = {MEGASTEP_K} launches at B={N_WORLDS}: device busy "
          f"{digest['device_busy_ms']:.3f} of {digest['span_ms']:.3f} ms, share "
          f"{digest['device_busy_frac']:.4f}; top device op {top[0][:60]} {top[1]:.3f} ms "
          f"({top[2]:.1f}% of busy); trace in {logdir}")
    check("megastep_kernel" in top[0], f"trace: the top device op is {top[0]}, not K2")
    return digest



def terrain_at_condim(condim: int):
    """The terrain fly compiled at ``condim``: its meta's condim set and each
    candidate's inverse weight repeated over the condim's pyramid rows (the
    JAX compile writes one value per candidate on every row)."""
    from flygym_tpu_torch import model_from_numpy
    from flygym_tpu_torch.compose.bridge import TERRAIN_FLY, _read_npz
    from flygym_tpu_torch.engine.contact import n_pyramid_rows

    arrays, meta = _read_npz(TERRAIN_FLY)
    meta["model"]["condim"] = condim
    invweight = arrays["model.can_invweight"]
    arrays["model.can_invweight"] = invweight[:, :1].repeat(n_pyramid_rows(condim), axis=1)
    return model_from_numpy(arrays, meta)


def phase_condim_kernels(flies: dict, terrain_compiled) -> dict:
    """K2 built for the benchmark fly at condim 1, 4 and 6 (NROWS 1, 6 and
    10 pyramid rows per candidate, K2 slice g.3) against its plain version
    from each golden's settled worlds with seeded joint noise and its first
    replay controls: condim 6 at the launches its replay makes, K = 1 and
    K = 8 at N_WORLDS, timed, with its bound; condim 1 and 4 with one K = 1
    launch at 1000 worlds. Then the terrain fly at CONDIM_TIMED
    (``terrain_at_condim``: its frames the sampled planes', so the torsional
    and rolling rows turn with them) with one K = 1 launch at 1000 worlds.
    All to K2_RTOL (measured 0 on the CPU's host build)."""
    from flygym_tpu_torch.compose.bridge import ASSETS, load_actuator_golden, load_terrain_golden

    out = {}
    for condim, compiled in flies.items():
        model = compiled.model.to("cuda")
        golden = load_actuator_golden(ASSETS / f"condim{condim}_fly_golden.npz")
        full = condim == CONDIM_TIMED
        out[condim] = k2_against_plain(
            f"condim{condim} kernel", model,
            lambda fn, n, k, seed, model=model, golden=golden: (
                *actuator_inputs(model, golden, n, k, seed), None),
            lambda state, _p: f"found share {state.contact_sensordata[..., 0].mean().item():.3f}",
            checks=((N_WORLDS, 1), (N_WORLDS, MEGASTEP_K)) if full else ((1000, 1),),
            timed=full)
    model = terrain_compiled.model.to("cuda")
    golden = load_terrain_golden()

    def inputs(fn, n, k, seed):
        state, seq = terrain_inputs(terrain_compiled, model, golden, n, k, seed)
        return state, seq, fn.sample_planes(state)

    k2_against_plain(
        f"terrain condim{CONDIM_TIMED} kernel", model, inputs,
        lambda _s, planes: f"share of tilted planes {(planes[..., 3] < 0.999).float().mean().item():.4f}",
        checks=((1000, 1),), timed=False)
    return out


def phase_replay_golden(compiled, golden_path, *, label: str) -> None:
    """A golden of per-step controls from the JAX settled state (the
    tethered fly's of ``scripts/export_actuator_golden.py``, the condim,
    soft-weld and PGS flies' of ``scripts/export_taxis_golden.py``): the K2
    path (where the model has it) against the JAX emitter with 0 gaps in
    qpos and qvel, and the found flags equal; the engine path against the
    JAX engine within GOLDEN_TOLERANCE."""
    import numpy as np

    from flygym_tpu_torch.compose.bridge import load_actuator_golden
    from flygym_tpu_torch.demo.benchmark import GOLDEN_TOLERANCE, track_controls
    from flygym_tpu_torch.ops.megastep import megastep_supported

    golden = load_actuator_golden(golden_path)
    n_steps, n_worlds = golden["ctrl"].shape[:2]
    paths = [("engine", False, "engine")]
    if megastep_supported(compiled.model):
        paths.insert(0, ("megastep", None, "emitter"))
    for path, megastep, record in paths:
        gaps = track_controls(compiled, golden, record, device="cuda", megastep=megastep)
        worst = {key: float(np.max(gap)) for key, gap in gaps.items()}
        print(f"[{label} golden {path}] {n_worlds} worlds x {n_steps} steps vs JAX {record}: "
              + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
              + ("" if megastep is None else f"; tolerances {GOLDEN_TOLERANCE}"))
        for key in ("qpos", "qvel", "found_share"):
            bar = 0.0 if megastep is None else GOLDEN_TOLERANCE[key]
            check(worst[key] <= bar, f"{label} golden {path}: {key} {worst[key]:.3e} > {bar}")


def taxis_yaw(qpos) -> "torch.Tensor":
    """Each world's root yaw (rad) from its free joint's quaternion."""
    import torch

    w, x, y, z = qpos[:, 3], qpos[:, 4], qpos[:, 5], qpos[:, 6]
    return torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))


def phase_taxis(taxis_compiled, n_worlds: int, label: str) -> dict:
    """Config 4 (example 07's visual taxis) at ``n_worlds`` through the
    default step, the batch built with ``megastep_k=PHYSICS_PER_CONTROL``:
    adhesion on, a TAXIS_SETTLE_STEPS rollout (K = 20 launches),
    TAXIS_WARMUP control steps, then TAXIS_STEPS timed control steps of
    ``demo/visual_taxis.py``: per control step one K3 launch and one K = 20
    K2 launch. Launches K2 and K3 TAXIS_WARMUP + TAXIS_STEPS each after the
    settle, K1/K1b 0; all state finite; every world's left legs
    slowed at the first control step (the pillar lies to the left); the
    travel bearing beside the pillar's, as example 07 prints them; control
    steps/s, world-steps/s and the realtime factor; at N_WORLDS the split
    of one control step by CUDA events and its host synchronisations."""
    import math

    import torch

    from flygym_tpu_torch import BatchSimulation
    from flygym_tpu_torch.demo.visual_taxis import PHYSICS_PER_CONTROL as K
    from flygym_tpu_torch.demo.visual_taxis import TaxisLoop
    from flygym_tpu_torch.ops import retina as rk

    fly = taxis_compiled.fly_names[0]
    sim = BatchSimulation(taxis_compiled, n_worlds, megastep_k=K)
    check(sim.megastep, f"{label}: the default step is not the mega-step on the card")
    sim.set_leg_adhesion_states(fly, torch.ones(6, device="cuda"))
    loop = TaxisLoop(sim)
    cs = loop.init_state(torch.Generator(device="cuda").manual_seed(0))
    reset_counts()
    sim.rollout(None, TAXIS_SETTLE_STEPS, record_trajectory=False)
    _state, _cs, _vision, drive0 = loop.control(sim.state, cs)
    left_slow = (drive0[:, :3] < drive0[:, 3:]).all(dim=1).float().mean().item()
    check(left_slow == 1.0, f"{label}: left legs slowed in {left_slow:.3f} of the worlds")
    cs, _rec = loop.run(cs, TAXIS_WARMUP)
    torch.cuda.synchronize()
    start = sim.state.qpos.clone()
    t0 = time.perf_counter()
    cs, _rec = loop.run(cs, TAXIS_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    n_ctrl = TAXIS_WARMUP + TAXIS_STEPS
    print(f"[{label}] config 4, {n_worlds} worlds: settle {TAXIS_SETTLE_STEPS} steps, "
          f"{TAXIS_WARMUP} + {TAXIS_STEPS} control steps of {K} physics steps; launches {counts}")
    want = {"megastep": TAXIS_SETTLE_STEPS // K + n_ctrl, "retina": n_ctrl + 1,
            "tree_ldl_factor": 0, "tree_ldl_solve": 0}
    for name, n in want.items():
        check(counts[name] == n, f"{label}: {name} launches {counts[name]} != {n}")
    st = sim.state
    for name in ("qpos", "qvel", "qacc", "xpos", "contact_sensordata"):
        check(bool(torch.isfinite(getattr(st, name)).all()), f"{label}: state.{name} not finite")
    check(bool(torch.isfinite(cs.phase).all()), f"{label}: CPG phase not finite")
    travel = st.qpos[:, :2] - start[:, :2]
    bearing = torch.rad2deg(torch.atan2(travel[:, 1], travel[:, 0]))
    turned = taxis_yaw(st.qpos) - taxis_yaw(start)
    turned = torch.rad2deg(torch.remainder(turned + math.pi, 2 * math.pi) - math.pi)
    print(f"[{label}] object bearing at start: {math.degrees(math.atan2(12.0, 25.0)):.1f} deg; "
          f"fly travel bearing mean {bearing.mean().item():.1f} deg (median "
          f"{bearing.median().item():.1f}), travelled {travel.norm(dim=1).mean().item():.3f} mm; "
          f"yaw turned mean {turned.mean().item():.2f} deg, share turning left "
          f"{(turned > 0).float().mean().item():.3f}; left legs slowed at the first control "
          f"step in {left_slow:.3f} of the worlds")
    ms_ctrl = wall / TAXIS_STEPS * 1e3
    fly_s = K * taxis_compiled.model.timestep
    print(f"[{label}] {TAXIS_STEPS} timed control steps in {wall:.3f} s: {ms_ctrl:.4f} ms per "
          f"control step, {TAXIS_STEPS / wall:.1f} control steps/s, "
          f"{TAXIS_STEPS * K * n_worlds / wall:.0f} world-steps/s, realtime factor "
          f"{fly_s / (ms_ctrl * 1e-3):.4f} ({fly_s * 1e3:.1f} ms of fly time per control step) "
          f"on {card_line()}")
    out = {"counts": counts, "ms_ctrl": ms_ctrl, "wall": wall}
    if n_worlds != N_WORLDS:
        return out

    # The split of one control step, by CUDA events over SPLIT_STEPS steps.
    render = loop.render
    tables = render.kernel.tables
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    parts = [0.0] * 5
    state = sim.state
    for _ in range(SPLIT_STEPS):
        ev[0].record()
        packed = rk.pack_rows(tables, state.xpos, state.xquat)
        ev[1].record()
        points = rk.launch_retina(tables, packed)
        ev[2].record()
        vision = render.blur(points)
        ev[3].record()
        state, cs, _drive = loop.steer(state, cs, vision)
        ev[4].record()
        state = loop.physics(state)
        ev[5].record()
        ev[5].synchronize()
        for i in range(5):
            parts[i] += ev[i].elapsed_time(ev[i + 1]) / SPLIT_STEPS
    out["split"] = parts
    print(f"[{label}] one control step: pack_rows {parts[0]:.3f} ms, K3 {parts[1]:.3f} ms, "
          f"blur {parts[2]:.3f} ms, drive + CPG + ctrl {parts[3]:.3f} ms, K = {K} K2 launch "
          f"with its packing {parts[4]:.3f} ms")
    print(f"[{label}] torch calls: render {torch_calls(lambda: render(state))}, drive + CPG + "
          f"ctrl {torch_calls(lambda: loop.steer(state, cs, vision))}, K2 launch with its "
          f"packing {torch_calls(lambda: loop.physics(state))}")
    syncs = host_syncs(lambda: loop.physics(loop.control(state, cs)[0]))
    print(f"[{label}] host synchronisations in one control step: {len(syncs)} {syncs}")
    check(not syncs, f"{label}: the control step waits for the card")
    return out


def phase_taxis_kernel(taxis_compiled) -> dict:
    """K2 built for config 4's world at K = 20, as its control step launches
    it, against its plain version on the card: the taxis golden's settled
    worlds repeated to N_WORLDS with seeded joint noise and the controls of
    the golden's first control step, one K = 20 launch against 20 chained
    plain steps on the same inputs (final state and qpos rows) to K2_RTOL,
    the plain version's time from that run (host clock: it runs one eager
    op per operation of the kernel). Then the launch's time on the same
    inputs (CUDA events) and its bound from the plain version's operations
    counted on the CPU."""
    import torch

    from flygym_tpu_torch import BatchSimulation
    from flygym_tpu_torch.compose.bridge import TAXIS_GOLDEN, load_loop_golden
    from flygym_tpu_torch.control import CPGState
    from flygym_tpu_torch.demo.visual_taxis import PHYSICS_PER_CONTROL as K
    from flygym_tpu_torch.demo.visual_taxis import TaxisLoop
    from flygym_tpu_torch.engine.kinematics import forward_kinematics
    from flygym_tpu_torch.ops import megastep

    golden = load_loop_golden(TAXIS_GOLDEN)
    n_golden = golden["state"].qpos.shape[0]
    sim = BatchSimulation(taxis_compiled, n_golden)
    sim.state = golden["state"].to("cuda")
    loop = TaxisLoop(sim)
    cs = CPGState.from_numpy(*(golden["controller"][k] for k in
                               ("phase", "amplitude", "damplitude")), device="cuda")
    ctrl0, _cs, _v, _d = loop.control(sim.state, cs)
    model = sim.model
    fn = megastep.make_megastep(model, K)

    idx = torch.arange(N_WORLDS, device="cuda") % n_golden
    state = ctrl0.map(lambda x: x[idx].clone())
    gen = torch.Generator(device="cuda").manual_seed(1)
    qpos = state.qpos.clone()
    qpos[:, model.hinge_qadr] += 0.01 * torch.randn(
        (N_WORLDS, model.nhinge), generator=gen, device="cuda")
    xpos, xquat = forward_kinematics(model, qpos)
    state = replace(state, qpos=qpos, xpos=xpos, xquat=xquat)
    seq = state.ctrl.expand(K, *state.ctrl.shape)

    got, traj = fn(state, seq)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want, wtraj = plain_steps(fn.static, state, seq)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    worst, gaps = 0.0, []
    for name, a, b in [("qpos rows", traj, wtraj)] + [
            (f, getattr(got, f), getattr(want, f)) for f in
            ("qpos", "qvel", "qacc", "xpos", "xquat", "actuator_force", "contact_sensordata")]:
        gap, scale = (a - b).abs().max().item(), b.abs().max().item()
        check(bool(torch.isfinite(a).all()), f"taxis kernel {name} not finite")
        check(gap <= K2_RTOL * scale, f"taxis kernel {name}: {gap:.3e} > {K2_RTOL} * {scale:.3e}")
        worst = max(worst, gap)
        gaps.append(f"{name} {gap:.2e}/{scale:.2e}")
    del want, wtraj
    print(f"[taxis kernel] B={N_WORLDS} K={K} max|kernel-plain|/max|plain|: "
          + ", ".join(gaps) + f"; plain {plain_ms:.1f} ms")
    runs = [time_ms(lambda: fn(state, seq), TIMED_LAUNCHES, warm_up=i == 0) for i in range(2)]
    ms_ = sum(runs) / 2
    ops = megastep_ops(model)
    n_in, n_out = megastep._io_rows(fn.static, K)
    bound = bound_ms(ops * K * N_WORLDS, 4 * (n_in + n_out) * N_WORLDS)
    print(f"[taxis kernel] K={K} at B={N_WORLDS}: kernel {ms_:.3f} ms per launch (runs "
          f"{runs[0]:.3f}/{runs[1]:.3f}), plain {plain_ms:.1f} ms; {ops} ops per world-step, "
          f"bound {bound[0]:.4f} ms ({bound[1]}), {ms_ / bound[0]:.0f}x the bound")
    return {"err": worst, "times": {K: (ms_, plain_ms)}, "bounds": {K: bound}}


def jax_paths_agree(golden: dict, n_steps: int):
    """The steps of a loop golden at which the JAX package's own two paths,
    its engine and its emitter, agree within GOLDEN_TOLERANCE in qpos and
    qvel: a walking fly's contacts switch on and off, and past that horizon
    the reference itself cannot tell a right step from a wrong one. Returns
    the (n_steps,) mask and the spreads."""
    import numpy as np

    from flygym_tpu_torch.demo.benchmark import GOLDEN_TOLERANCE

    spread = {key: np.abs(golden["engine"][key] - golden["emitter"][key]).reshape(
        n_steps, -1).max(axis=1) for key in ("qpos", "qvel")}
    held = (spread["qpos"] <= GOLDEN_TOLERANCE["qpos"]) & (spread["qvel"] <= GOLDEN_TOLERANCE["qvel"])
    return held, spread


def loop_probe_bars(golden: dict, n_steps: int) -> dict:
    """Per-step bars of a loop golden in qpos and qvel: three times the
    spread of the JAX engine's conditioning probe (the same loop from the
    settled state perturbed by 1e-5) from the JAX engine, or PROBE_FLOOR,
    whichever is larger. They say how far the walk itself carries a
    difference of float32 rounding's size, as the two-fly goldens' bars
    do."""
    import numpy as np

    return {key: np.maximum(3.0 * np.abs(golden["probe"][key] - golden["engine"][key]).reshape(
        n_steps, -1).max(axis=1), PROBE_FLOOR[key]) for key in ("qpos", "qvel")}


def phase_taxis_golden(taxis_compiled) -> None:
    """The taxis golden, 8 worlds x 10 control steps (200 physics steps)
    from the JAX settled state with its controllers. First the retina and
    the drive at every control step, rendered from the poses each JAX path
    recorded (the settled state's at the first): the vision within 1e-5 on
    RETINA_SHARE of the ommatidia, the drive within TAXIS_DRIVE_ATOL of
    what the vision's gap implies (a ray the retina shades otherwise, as
    K3 may on 0.1% of them, moves the drive by gain x its gap / 1442). Then
    the loops: the K2 path fed the golden's drives repeats the JAX emitter's
    loop with 0 gaps in qpos, qvel and the CPG phase. With their own vision,
    the K2 path against the JAX emitter's loop and the engine path against
    the JAX engine's: within GOLDEN_TOLERANCE (the drive within
    TAXIS_DRIVE_ATOL) at the control steps where the JAX engine and the JAX
    emitter agree within it (``jax_paths_agree``: the first; from the second
    they part by up to ~6 in qvel), and at every control step within the
    probe's bars (``loop_probe_bars``)."""
    import numpy as np
    import torch

    from flygym_tpu_torch import BatchSimulation
    from flygym_tpu_torch.compose.bridge import TAXIS_GOLDEN, load_loop_golden
    from flygym_tpu_torch.control import CPGState, object_azimuth_drive
    from flygym_tpu_torch.demo.benchmark import GOLDEN_TOLERANCE
    from flygym_tpu_torch.demo.visual_taxis import PHYSICS_PER_CONTROL, TAXIS_GAIN, TaxisLoop

    golden = load_loop_golden(TAXIS_GOLDEN)
    n_worlds = golden["state"].qpos.shape[0]
    n_steps = golden["engine"]["qpos"].shape[0]
    held, spread = jax_paths_agree(golden, n_steps)
    bars = loop_probe_bars(golden, n_steps)
    check(bool(held[0]), "taxis golden: the JAX paths part at the first control step")
    settled = golden["state"].to("cuda")
    render = TaxisLoop(BatchSimulation(taxis_compiled, n_worlds)).render
    for record in ("engine", "emitter"):
        want = golden[record]
        shares, drive_gaps, excess = [], [], []
        for t in range(n_steps):
            pose = settled if t == 0 else replace(
                settled, xpos=torch.from_numpy(want["xpos"][t - 1]).cuda(),
                xquat=torch.from_numpy(want["xquat"][t - 1]).cuda())
            vision = render(pose)
            gap = np.abs(vision.cpu().numpy() - want["vision"][t])
            shares.append(float((gap <= 1e-5).mean()))
            drive = object_azimuth_drive(vision, TAXIS_GAIN).cpu().numpy()
            # Each eye's brightness is the mean of its 2 x 721 values, so the
            # drive moves by at most the gain times the vision's summed gap
            # over 1442, with float32 rounding on top.
            drive_gap = np.abs(drive - want["drive"][t]).max(axis=1)
            implied = TAXIS_GAIN * gap.reshape(n_worlds, -1).sum(axis=1) / gap[0, 0].size
            drive_gaps.append(float(drive_gap.max()))
            excess.append(float((drive_gap - implied).max()))
        print(f"[taxis golden vision] from the JAX {record}'s poses at each of {n_steps} "
              f"control steps: vision within 1e-5 on at least {min(shares):.5f} of the "
              f"ommatidia; drive gap at most {max(drive_gaps):.3e}, past what the vision's gap "
              f"implies by at most {max(excess):.3e}")
        check(min(shares) >= RETINA_SHARE,
              f"taxis golden vision ({record}): share {min(shares)} < {RETINA_SHARE}")
        check(max(excess) <= TAXIS_DRIVE_ATOL,
              f"taxis golden drive ({record}): {max(excess):.3e} past the vision's gap")
    tol = {**GOLDEN_TOLERANCE, "drive": TAXIS_DRIVE_ATOL}
    for label, megastep, record, fed in (("megastep, JAX's drives", None, "emitter", True),
                                         ("megastep", None, "emitter", False),
                                         ("engine", False, "engine", False)):
        want = golden[record]
        sim = BatchSimulation(taxis_compiled, n_worlds, megastep=megastep,
                              megastep_k=PHYSICS_PER_CONTROL)
        check(sim.megastep == (megastep is None), f"taxis golden {label}: wrong step")
        sim.state = settled
        loop = TaxisLoop(sim)
        cs = CPGState.from_numpy(*(golden["controller"][k] for k in
                                   ("phase", "amplitude", "damplitude")), device="cuda")
        drives = torch.from_numpy(want["drive"]).cuda() if fed else None
        _cs, rec = loop.run(cs, n_steps, record=True, drives=drives)
        for key in ("qpos", "qvel", "phase"):
            check(bool(torch.isfinite(rec[key]).all()), f"taxis golden {label}: {key} not finite")
        gaps = {k: np.abs(rec[k].cpu().numpy() - want[k]).reshape(n_steps, -1).max(axis=1)
                for k in ("qpos", "qvel", "phase", "drive")}
        print(f"[taxis golden {label}] {n_worlds} worlds x {n_steps} control steps vs JAX "
              f"{record}: " + ", ".join(f"{k} {v.max():.3e} (step 1 {v[0]:.3e})"
                                        for k, v in gaps.items()))
        if fed:
            check(all(gaps[k].max() == 0.0 for k in ("qpos", "qvel", "phase")),
                  f"taxis golden {label}: the K2 path must repeat JAX")
            continue
        for key in ("qpos", "qvel", "drive"):
            bad = np.flatnonzero(held & (gaps[key] > tol[key]))
            check(not len(bad), f"taxis golden {label} {key} at control step {bad[:1] + 1}: "
                                f"{gaps[key][bad[:1]]} > {tol[key]}")
        for key in ("qpos", "qvel"):
            bad = np.flatnonzero(gaps[key] > bars[key])
            check(not len(bad), f"taxis golden {label} {key} at control step {bad[:1] + 1}: "
                                f"{gaps[key][bad[:1]]} > the probe's bar {bars[key][bad[:1]]}")
        print(f"[taxis golden {label}] held to GOLDEN_TOLERANCE at control steps "
              f"{[int(i) + 1 for i in np.flatnonzero(held)]} and to the probe's bars at all "
              f"{n_steps}; per step qvel gap / probe bar / the JAX engine-emitter spread: "
              + ", ".join(f"{g:.2e}/{b:.2e}/{sp:.2e}" for g, b, sp in
                          zip(gaps["qvel"], bars["qvel"], spread["qvel"])))


def phase_cpg_walking(cpg_compiled) -> dict:
    """Config 2 (example 04's CPG walking) at N_WORLDS through the default
    step: adhesion on, a TAXIS_SETTLE_STEPS rollout (K = 8 launches), then
    CPG_WALK_STEPS timed steps of ``demo/cpg_walking.py`` (one CPG step and
    one K = 1 K2 launch each). Launches K2 settle / 8 + CPG_WALK_STEPS,
    K1/K1b 0; all state finite; distance walked, world-steps/s, torch calls
    per step and no host synchronisation in a step."""
    import torch

    from flygym_tpu_torch import BatchSimulation
    from flygym_tpu_torch.demo.cpg_walking import CPGWalkingLoop

    fly = cpg_compiled.fly_names[0]
    sim = BatchSimulation(cpg_compiled, N_WORLDS)
    check(sim.megastep, "config 2: the default step is not the mega-step on the card")
    sim.set_leg_adhesion_states(fly, torch.ones(6, device="cuda"))
    loop = CPGWalkingLoop(sim)
    cs = loop.init_state(torch.Generator(device="cuda").manual_seed(0))
    reset_counts()
    sim.rollout(None, TAXIS_SETTLE_STEPS, record_trajectory=False)
    torch.cuda.synchronize()
    start = sim.state.qpos[:, :2].clone()
    t0 = time.perf_counter()
    cs, _rec = loop.run(cs, CPG_WALK_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    print(f"[cpg walking] config 2, {N_WORLDS} worlds: settle {TAXIS_SETTLE_STEPS} steps, "
          f"{CPG_WALK_STEPS} steps; launches {counts}")
    want = {"megastep": TAXIS_SETTLE_STEPS // MEGASTEP_K + CPG_WALK_STEPS,
            "tree_ldl_factor": 0, "tree_ldl_solve": 0}
    for name, n in want.items():
        check(counts[name] == n, f"cpg walking: {name} launches {counts[name]} != {n}")
    st = sim.state
    for name in ("qpos", "qvel", "qacc", "xpos", "contact_sensordata"):
        check(bool(torch.isfinite(getattr(st, name)).all()), f"cpg walking: {name} not finite")
    walked = (st.qpos[:, :2] - start).norm(dim=1)
    z = st.qpos[:, 2]
    print(f"[cpg walking] root z min/mean/max {z.min().item():.4f}/{z.mean().item():.4f}/"
          f"{z.max().item():.4f} mm, walked mean {walked.mean().item():.4f} mm (max "
          f"{walked.max().item():.4f}) in {CPG_WALK_STEPS * cpg_compiled.model.timestep:.3f} s")
    print(f"[cpg walking] {wall / CPG_WALK_STEPS * 1e3:.4f} ms per step: "
          f"{CPG_WALK_STEPS * N_WORLDS / wall:.0f} world-steps/s on {card_line()}")
    state = sim.state
    print(f"[cpg walking] torch calls per step: {torch_calls(lambda: loop.step(state, cs))}")
    syncs = host_syncs(lambda: loop.step(state, cs))
    print(f"[cpg walking] host synchronisations in one step: {len(syncs)} {syncs}")
    check(not syncs, "cpg walking: the step waits for the card")
    return counts


def phase_cpg_golden(cpg_compiled) -> None:
    """The CPG walking golden, 8 worlds x 40 steps from the JAX settled
    state with its controllers: the K2 path against the JAX emitter's loop
    with 0 gaps in qpos, qvel and the CPG phase; the engine path against the
    JAX engine's within GOLDEN_TOLERANCE at the steps where the JAX paths
    agree within it (``jax_paths_agree``) and within the probe's bars
    (``loop_probe_bars``) at every step, the phase equal."""
    import numpy as np
    import torch

    from flygym_tpu_torch import BatchSimulation
    from flygym_tpu_torch.compose.bridge import CPG_GOLDEN, load_loop_golden
    from flygym_tpu_torch.control import CPGState
    from flygym_tpu_torch.demo.benchmark import GOLDEN_TOLERANCE
    from flygym_tpu_torch.demo.cpg_walking import CPGWalkingLoop

    golden = load_loop_golden(CPG_GOLDEN)
    n_worlds = golden["state"].qpos.shape[0]
    n_steps = golden["engine"]["qpos"].shape[0]
    held, _spread = jax_paths_agree(golden, n_steps)
    bars = loop_probe_bars(golden, n_steps)
    for label, megastep, record in (("megastep", None, "emitter"), ("engine", False, "engine")):
        want = golden[record]
        sim = BatchSimulation(cpg_compiled, n_worlds, megastep=megastep)
        sim.state = golden["state"].to("cuda")
        loop = CPGWalkingLoop(sim)
        cs = CPGState.from_numpy(*(golden["controller"][k] for k in
                                   ("phase", "amplitude", "damplitude")), device="cuda")
        _cs, rec = loop.run(cs, n_steps, record=True)
        gaps = {k: np.abs(rec[k].cpu().numpy() - want[k]).reshape(n_steps, -1).max(axis=1)
                for k in ("qpos", "qvel", "phase")}
        print(f"[cpg golden {label}] {n_worlds} worlds x {n_steps} steps vs JAX {record}: "
              + ", ".join(f"{k} {v.max():.3e}" for k, v in gaps.items())
              + ("" if megastep is None else f"; held to GOLDEN_TOLERANCE at {int(held.sum())} "
                                             f"of {n_steps} steps (where the JAX paths agree)"))
        check(gaps["phase"].max() == 0.0, f"cpg golden {label}: phase {gaps['phase'].max():.3e}")
        for key in ("qpos", "qvel"):
            check(bool(torch.isfinite(rec[key]).all()), f"cpg golden {label}: {key} not finite")
            if megastep is None:
                check(gaps[key].max() == 0.0, f"cpg golden {label}: {key} {gaps[key].max():.3e}")
            else:
                worst = float(gaps[key][held].max()) if held.any() else 0.0
                check(worst <= GOLDEN_TOLERANCE[key],
                      f"cpg golden {label}: {key} {worst:.3e} > {GOLDEN_TOLERANCE[key]}")
                ratio = float((gaps[key] / bars[key]).max())
                print(f"[cpg golden {label}] {key}: largest gap / probe bar {ratio:.3f}")
                check(ratio <= 1.0, f"cpg golden {label}: {key} past the probe's bar")


def phase_solvers(weld_compiled, pgs_compiled) -> dict:
    """The engine-only variants at N_WORLDS: the soft-welded fly (its root
    pinned by the soft weld; no contact candidate, so one K1 and one K1b
    launch per step) and the PGS fly (a dense Cholesky and row-sequential
    Gauss-Seidel sweeps, no K1/K1b), each from its golden's settled worlds
    with the replay's first controls held, SOLVER_STEPS timed engine steps:
    launch counts, all state finite, the soft-welded roots within 1e-3 mm
    of their tether; ms per step; the host synchronisations of one engine
    step of each, and none in the soft weld's forces. Then each golden (8
    worlds x 20 steps) against the JAX engine within GOLDEN_TOLERANCE."""
    import torch

    from flygym_tpu_torch import BatchSimulation
    from flygym_tpu_torch.compose.bridge import ASSETS, load_actuator_golden
    from flygym_tpu_torch.engine import step as engine_step

    out = {}
    for label, compiled, name in (("soft weld", weld_compiled, "softweld_fly"),
                                  ("pgs", pgs_compiled, "pgs_fly")):
        golden = load_actuator_golden(ASSETS / f"{name}_golden.npz")
        sim = BatchSimulation(compiled, N_WORLDS)
        check(not sim.megastep, f"{label}: K2 took a model it refuses")
        idx = torch.arange(N_WORLDS) % golden["state"].qpos.shape[0]
        sim.state = replace(golden["state"].map(lambda x: x[idx].clone()),
                            ctrl=torch.as_tensor(golden["ctrl"][0])[idx]).to("cuda")
        sim.rollout(None, 1, record_trajectory=False)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        sim.rollout(None, SOLVER_STEPS, record_trajectory=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        per_step = 1 if label == "soft weld" else 0
        want = {"megastep": 0, "tree_ldl_factor": per_step * SOLVER_STEPS,
                "tree_ldl_solve": per_step * SOLVER_STEPS}
        for key, n in want.items():
            check(counts[key] == n, f"{label}: {key} launches {counts[key]} != {n}")
        st = sim.state
        for key in ("qpos", "qvel", "qacc"):
            check(bool(torch.isfinite(getattr(st, key)).all()), f"{label}: {key} not finite")
        if label == "soft weld":
            tether = torch.tensor(compiled.model.welds[0][3], device="cuda")
            off = (st.qpos[:, :3] - tether).abs().max().item()
            check(off <= 1e-3, f"soft weld: a root {off:.3e} mm off its tether")
            extra = f", largest root offset from the tether {off:.3e} mm"
        else:
            extra = f", root z mean {st.qpos[:, 2].mean().item():.4f} mm"
        ms_step = wall / SOLVER_STEPS * 1e3
        out[label] = ms_step
        print(f"[{label}] {N_WORLDS} worlds, {SOLVER_STEPS} engine steps in {wall:.3f} s: "
              f"{ms_step:.3f} ms per step, {SOLVER_STEPS * N_WORLDS / wall:.0f} world-steps/s; "
              f"launches {counts}{extra} on {card_line()}")
        syncs = host_syncs(lambda: sim.rollout(None, 1, record_trajectory=False))
        print(f"[{label}] host synchronisations in one engine step: {len(syncs)} "
              f"{sorted(set(syncs))}")
        if label == "soft weld":
            eye = torch.eye(st.qvel.shape[1], device="cuda").expand(N_WORLDS, -1, -1)
            syncs = host_syncs(lambda: engine_step._weld_forces(sim.model, st.qpos, st.qvel, eye))
            print(f"[soft weld] host synchronisations in the weld forces: {len(syncs)} {syncs}")
            check(not syncs, "soft weld: the weld forces wait for the card")
        phase_replay_golden(compiled, ASSETS / f"{name}_golden.npz", label=label)
    return out


# The camera renderer (phases 40-44): the golden's cases, and the cases
# timed at full size, (name, (height, width)): one world with capsules and
# with mesh fidelity, 16 worlds, config 3's terrain and FlyEnv's frame.
RENDER_FULL = (("capsule", (240, 320)), ("mesh", (240, 320)), ("batch", (120, 160)),
               ("terrain", (240, 320)), ("flyenv", (240, 320)))
RENDER_TIMED = 5  # frames per timing
RENDER_HOOK_STEPS = 200  # step_with_profile() + render_as_needed_with_profile()
RENDER_BATCH_WORLDS = 16
RENDER_BENCH = (1, 4, 4)  # run_benchmark(1, 4, 4, enable_rendering=True)
RETINA_HF_WORLDS = 8  # the heightfield retina on the card (the terrain golden's worlds)


def _cpu_frame(case: str, res, golden) -> "torch.Tensor":
    from flygym_tpu_torch.demo.render_cases import render_case

    return render_case(case, device="cpu", res=res, golden=golden)()


def phase_render_golden() -> None:
    """Each case of the JAX render golden rendered on the card from the same
    state, held against the golden and against the port's CPU frame, to
    ``FRAME_BARS``."""
    import torch

    from flygym_tpu_torch.demo.render_cases import (
        CASES, FRAME_BARS, frame_gap, load_render_golden, render_case)

    golden = load_render_golden()
    for case in CASES:
        frame = render_case(case, device="cuda", golden=golden)()
        check(frame.is_cuda and bool(torch.isfinite(frame).all()), f"render {case}: not finite")
        vs_jax = frame_gap(frame, golden["frames"][case])
        vs_cpu = frame_gap(frame, _cpu_frame(case, None, golden))
        print(f"[render golden] {case} {tuple(frame.shape)}: vs JAX share {vs_jax['share']:.5f} "
              f"mean {vs_jax['mean']:.2e} max {vs_jax['max']:.2e}; vs the port on the CPU share "
              f"{vs_cpu['share']:.5f} mean {vs_cpu['mean']:.2e} (bars {FRAME_BARS})")
        check(vs_jax["ok"], f"render {case}: the card's frame against the JAX golden {vs_jax}")
        check(vs_cpu["ok"], f"render {case}: the card's frame against the CPU's {vs_cpu}")


def phase_render_frames() -> dict:
    """The timed cases at full size on the card: each frame held against the
    port's CPU frame of the same inputs, its ms by CUDA events, and for one
    world's capsule and mesh frames a profiler trace (device ops launched,
    the card's busy share)."""
    import torch

    from flygym_tpu_torch.demo.render_cases import frame_gap, load_render_golden, render_case
    from flygym_tpu_torch.utils.profiling import summarize_trace, trace

    golden = load_render_golden()
    out = {}
    for case, res in RENDER_FULL:
        fn = render_case(case, device="cuda", res=res, golden=golden)
        torch.cuda.reset_peak_memory_stats()
        frame = fn()
        gap = frame_gap(frame, _cpu_frame(case, res, golden))
        ms = time_ms(fn, RENDER_TIMED)
        peak = torch.cuda.max_memory_allocated() / 2**20
        out[case] = ms
        print(f"[render] {case} {fn.worlds} x {res[0]} x {res[1]}: {ms:.3f} ms per call "
              f"({ms / fn.worlds:.3f} ms per world's frame), peak {peak:.0f} MiB; vs the CPU "
              f"share {gap['share']:.5f} mean {gap['mean']:.2e} max {gap['max']:.2e}; "
              f"on {card_line()}")
        check(gap["ok"], f"render {case} at {res}: the card's frame against the CPU's {gap}")
        if case in ("capsule", "mesh"):
            logdir = Path(__file__).resolve().parent / "outputs" / f"render_trace_{case}"
            with trace(str(logdir), summarize=False):
                fn()
                torch.cuda.synchronize()
            digest = summarize_trace(str(logdir))
            check(digest is not None and digest["device_events"] > 0, f"render {case}: trace")
            print(f"[render] {case} frame traced: {digest['device_events']} device ops, busy "
                  f"{digest['device_busy_ms']:.3f} of {digest['span_ms']:.3f} ms (share "
                  f"{digest['device_busy_frac']:.4f})")
    return out


def phase_render_hooks(compiled) -> None:
    """The simulation's render hooks on the card, with K2 stepping between
    frames: ``Simulation`` with ``set_renderer("nmf/trackcam")`` and
    RENDER_HOOK_STEPS ``step_with_profile()`` + ``render_as_needed_with_
    profile()`` (one frame per 80 steps: 3), the report; ``save_video`` into
    ``outputs/`` where imageio or PIL is installed; then ``BatchSimulation``
    of RENDER_BATCH_WORLDS worlds rendering all of them at 120 x 160."""
    import importlib.util

    import torch

    from flygym_tpu_torch import BatchSimulation, Simulation

    fly = compiled.fly_names[0]
    want_frames = -(-RENDER_HOOK_STEPS // 80)
    for label, sim, kw in (
            ("one world", Simulation(compiled), {}),
            (f"{RENDER_BATCH_WORLDS} worlds", BatchSimulation(compiled, RENDER_BATCH_WORLDS),
             {"camera_res": (120, 160), "world_ids": range(RENDER_BATCH_WORLDS)})):
        renderer = sim.set_renderer(f"{fly}/trackcam", **kw)
        sim.set_leg_adhesion_states(fly, torch.ones(6, device="cuda"))
        reset_counts()
        for _ in range(RENDER_HOOK_STEPS):
            sim.step_with_profile()
            sim.render_as_needed_with_profile()
        torch.cuda.synchronize()
        counts = read_counts()
        frames = renderer.get_frames()
        print(f"[render hooks] {label}: {RENDER_HOOK_STEPS} steps, launches {counts}, frames "
              f"{sim._frames_rendered} of {tuple(frames[0].shape)} {frames[0].dtype} on "
              f"{frames[0].device}, render time {sim._total_render_time_ns / 1e6:.3f} ms "
              f"({sim._total_render_time_ns / 1e6 / max(sim._frames_rendered, 1):.3f} ms per "
              f"frame), physics {sim._total_physics_time_ns / 1e6:.3f} ms")
        check(counts["megastep"] == RENDER_HOOK_STEPS and counts["tree_ldl_factor"] == 0,
              f"render hooks {label}: launches {counts}")
        check(sim._frames_rendered == want_frames == len(frames)
              and sim._total_render_time_ns > 0, f"render hooks {label}: counters")
        check(all(f.is_cuda and f.dtype == torch.uint8 for f in frames)
              and float(frames[-1].float().std()) > 10, f"render hooks {label}: frames")
        sim.print_performance_report(show_in_notebook=False)
        if any(importlib.util.find_spec(m) is not None for m in ("imageio", "PIL")):
            path = Path(__file__).resolve().parent / "outputs" / f"render_{sim.n_worlds}.mp4"
            renderer.save_video(path)
            written = [p for p in (path, path.with_suffix(".gif")) if p.exists()]
            check(bool(written), f"render hooks {label}: save_video wrote nothing")
            print(f"[render hooks] save_video: {written[0].name}, {written[0].stat().st_size} "
                  "bytes")
        else:
            print("[render hooks] save_video skipped: neither imageio nor PIL is installed here")


def phase_render_benchmark() -> None:
    """``run_benchmark(1, 4, 4, enable_rendering=True)``: each run's 750 K2
    launches, its timed replay as before, and one frame after it."""
    import torch

    from flygym_tpu_torch.demo.benchmark import run_benchmark

    reset_counts()
    cols = run_benchmark(*RENDER_BENCH, enable_rendering=True)
    counts = read_counts()
    n_runs = len(cols["n_worlds"])
    frames = cols["frames"]
    print(f"[render benchmark] run_benchmark{RENDER_BENCH}: worlds {cols['n_worlds'].tolist()}, "
          f"world-steps/s {[round(x) for x in cols['steps_per_second']]}, launches {counts}, "
          f"frames {[len(f) for f in frames]} of {tuple(frames[0][0].shape)}")
    check(n_runs == 2 and counts["megastep"] == n_runs * (SETTLE_STEPS + 2 * (N_STEPS // 8)),
          f"render benchmark: {n_runs} runs, launches {counts}")
    check(all(len(f) == 1 and f[0].shape == (1, 240, 320, 3) and f[0].dtype == torch.uint8
              for f in frames), "render benchmark: one frame per run")


def phase_render_vision(env_compiled, terrain_compiled) -> None:
    """FlyEnv's frame function on the card without gymnasium, and the
    retina's choice: on the terrain fly's heightfield the port of JAX's jnp
    path (no K3 launch), held against the CPU's; on config 5's flat world
    one K3 launch."""
    import torch

    from flygym_tpu_torch.compose.bridge import load_env_golden, load_terrain_golden
    from flygym_tpu_torch.env.gym import env_frame
    from flygym_tpu_torch.vision import Retina

    state = load_env_golden()["state"].to("cuda")
    frame = env_frame(env_compiled.model.to("cuda"), state, int(env_compiled.env["root_body"]))
    check(frame.shape == (state.xpos.shape[0], 240, 320, 3) and bool(torch.isfinite(frame).all()),
          "FlyEnv's frame")
    print(f"[render vision] env_frame: {tuple(frame.shape)} on {frame.device}, "
          f"'gymnasium' imported: {'gymnasium' in sys.modules}")
    ids = terrain_compiled.render["body_name2id"]
    fly = terrain_compiled.fly_names[0]
    tmodel = terrain_compiled.model
    retina = Retina.build(tmodel, ids[f"{fly}/l_eye"], ids[f"{fly}/r_eye"])
    tstate = load_terrain_golden()["state"].map(lambda x: x[:RETINA_HF_WORLDS].clone())
    render = retina.make_render_batched(tmodel.to("cuda"))
    check(render.kernel is None, "the heightfield retina chose K3")
    reset_counts()
    got = render(tstate.to("cuda"))
    torch.cuda.synchronize()
    counts = read_counts()
    want = retina.make_render_batched(tmodel)(tstate)
    share = ((got.cpu() - want).abs() <= VISION_GOLDEN[0]).float().mean().item()
    ms = time_ms(lambda: render(tstate.to("cuda")), 3)
    print(f"[render vision] heightfield retina {tuple(got.shape)}: K3 launches "
          f"{counts['retina']}, vs the CPU share within {VISION_GOLDEN[0]} {share:.5f}, "
          f"{ms:.3f} ms per call")
    check(counts["retina"] == 0 and share >= VISION_GOLDEN[1], "the heightfield retina")
    flat = Retina.for_compiled(env_compiled).make_render_batched(env_compiled.model.to("cuda"))
    reset_counts()
    vision = flat(state)
    torch.cuda.synchronize()
    counts = read_counts()
    check(flat.kernel is not None and counts["retina"] == 1 and bool(torch.isfinite(vision).all()),
          f"the flat world's retina: launches {counts}")
    print(f"[render vision] flat world's retina: one K3 launch ({counts['retina']})")


# ---------------------------------------------------------------------------
# Phases 45-48: worlds the port composes and compiles
# ---------------------------------------------------------------------------


def compose(name: str):
    """``(fly, world)`` of a world the port composes, compiled on the CPU:
    ``make_model`` with one of COMPOSED_OPTIONS, or a committed world of
    ``demo/worlds.py``."""
    from flygym_tpu_torch.demo.benchmark import make_model
    from flygym_tpu_torch.demo.worlds import build_world

    if name in COMPOSED_OPTIONS:
        fly, world, _cam = make_model(**COMPOSED_OPTIONS[name])
    elif name.startswith("two_flies_"):  # two_flies_c<condim> or two_flies_terrain
        terrain = name == "two_flies_terrain"
        return None, compose_two_flies(3 if terrain else int(name[len("two_flies_c"):]),
                                       terrain)
    else:
        fly, world = build_world(name)
    world.compile()
    return fly, world


def compose_default_env():
    """``VectorFlyEnv()``'s world (``env/gym.py:_build_default_world``),
    compiled on the CPU."""
    from flygym_tpu_torch.env.gym import _build_default_world

    _fly, world = _build_default_world()
    world.compile()
    return world


def example_worlds() -> dict:
    """The worlds examples 01, 02 and 12 in torch compose (phases 62-63),
    compiled for phase 1's build (example 03's is the composed benchmark
    world)."""
    from flygym_tpu_torch.demo.benchmark import make_model
    from flygym_tpu_torch.demo.build_a_fly import build_fly_world
    from flygym_tpu_torch.demo.multichip_scaling import make_world

    worlds = {"example 01": build_fly_world()[1],
              "example 02": make_model(spawn_position=(0, 0, 1.2))[1],
              "example 12": make_world()}
    for world in worlds.values():
        world.compile()
    return {f"{name}'s world": w.compiled for name, w in worlds.items()}


def compose_all() -> dict:
    """Every world of phases 45-47, composed and compiled on the CPU."""
    out = {}
    for name in (*COMPOSED_OPTIONS, "tethered_fly", "terrain_fly"):
        t0 = time.perf_counter()
        out[name] = compose(name)
        m = out[name][1].compiled.model
        print(f"[compose] {name}: composed and compiled on the CPU in "
              f"{time.perf_counter() - t0:.2f} s (nv {m.nv}, ncand {m.ncand}, nu {m.nu}, "
              f"contact sensors {m.nsensor_contact})")
    return out


def compile_gaps(world, path) -> list:
    """The port's compile of ``world`` against the exported file ``path``:
    fails unless every field is bit-equal but those of COMPOSED_BARS (within
    their relative bars) and ``state.xquat`` (within XQUAT_ULPS), and the
    metadata equal; returns the fields that part, with their gaps."""
    import numpy as np

    from flygym_tpu_torch.compose.bridge import _read_npz

    arrays, meta, _names = world.compile_arrays()
    ref, ref_meta = _read_npz(path)
    check(sorted(arrays) == sorted(ref), f"{path.name}: the composed fields differ")
    parted = []
    for key, want in ref.items():
        got = arrays[key]
        check(got.dtype == want.dtype and got.shape == want.shape, f"{key}: dtype or shape")
        if np.array_equal(got, want):
            continue
        if key in COMPOSED_BARS:
            rel = float((np.abs(got.astype(np.float64) - want)
                         / np.maximum(np.abs(want), 1e-30)).max())
            check(rel <= COMPOSED_BARS[key], f"{key}: relative gap {rel:.3e}")
            parted.append(f"{key} (relative {rel:.2e})")
        elif key == "state.xquat":
            ulps = int(np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32)).max())
            check(ulps <= XQUAT_ULPS, f"{key}: {ulps} ulps")
            parted.append(f"{key} ({ulps} ulps in {int((got != want).sum())} entries)")
        else:
            check(False, f"{path.name}: {key} is not bit-equal to the file's")
    flies = {fly: {k: v for k, v in maps.items() if k not in ("tip_bodies", "eye_bodies")}
             for fly, maps in ref_meta["flies"].items()}
    check(meta["model"] == ref_meta["model"] and meta["flies"] == flies,
          f"{path.name}: the composed metadata differs")
    check(ref_meta.get("render", meta["render"]) == meta["render"],
          f"{path.name}: the composed render metadata differs")
    return parted


def phase_composed_benchmark(world) -> tuple:
    """Phase 45: the benchmark world the port composed against its file, K2
    built for it against its plain version, the replay protocol and the
    goldens."""
    from flygym_tpu_torch.compose.bridge import ASSETS, BENCHMARK_FLY, BENCHMARK_GOLDEN, load_golden

    parted = compile_gaps(world, BENCHMARK_FLY)
    print(f"[composed] the benchmark world against benchmark_fly.npz: every field and the "
          f"metadata bit-equal but {', '.join(parted) or 'none'}")
    compiled = world.compiled
    golden = load_golden()
    k2 = k2_against_plain(
        "composed kernel", compiled.model.to("cuda"),
        lambda fn, n, k, seed: (*k2_inputs(compiled, golden, n, k), None),
        checks=((N_WORLDS, 1), (N_WORLDS, MEGASTEP_K)))
    counts, _wall, sim = phase_slice(
        compiled, label="composed", megastep=None, settle=SETTLE_STEPS, steps=N_STEPS,
        want={"megastep": SETTLE_STEPS + 2 * (N_STEPS // MEGASTEP_K),
              "tree_ldl_factor": 0, "tree_ldl_solve": 0}, return_sim=True)
    phase_golden(compiled, label="composed golden megastep",
                 golden_path=ASSETS / "benchmark_fly_megastep_golden.npz", megastep=True)
    phase_golden(compiled, label="composed golden engine", golden_path=BENCHMARK_GOLDEN,
                 megastep=False)
    return k2, counts, sim


def fly_com(model, state) -> "torch.Tensor":
    """(B, 3) centre of mass of every body of each world."""
    from flygym_tpu_torch.engine.maths import quat_rotate

    com = state.xpos + quat_rotate(state.xquat, model.body_ipos)
    return (model.body_mass[:, None] * com).sum(1) / model.body_mass.sum()


def phase_composed_options(composed: dict, bench_sim) -> dict:
    """Phase 46: ``trim_contacts`` and ``simplify_geom``, each K2 against its
    plain version and the replay protocol; the trimmed fly against phase
    45's run."""
    from flygym_tpu_torch.compose.bridge import load_golden

    golden = load_golden()
    counts = {}
    for name in ("trim_contacts", "simplify_geom"):
        compiled = composed[name][1].compiled
        n_sensors = compiled.model.nsensor_contact

        def inputs(fn, n, k, seed, compiled=compiled):
            state, seq = k2_inputs(compiled, golden, n, k)
            rows = state.contact_sensordata[:, :n_sensors].clone()
            return replace(state, contact_sensordata=rows), seq, None

        k2_against_plain(f"composed {name} kernel", compiled.model.to("cuda"), inputs,
                         checks=((N_WORLDS, 1),), timed=False)
        counts[name], _wall, sim = phase_slice(
            compiled, label=f"composed {name}", megastep=None, settle=SETTLE_STEPS,
            steps=N_STEPS, want={"megastep": SETTLE_STEPS + 2 * (N_STEPS // MEGASTEP_K),
                                 "tree_ldl_factor": 0, "tree_ldl_solve": 0}, return_sim=True)
        if name == "trim_contacts":
            full, trim = bench_sim.state, sim.state
            root = (trim.qpos[:, :3] - full.qpos[:, :3]).norm(dim=-1).max().item()
            com = (fly_com(sim.model, trim) - fly_com(bench_sim.model, full)).norm(dim=-1)
            print(f"[composed trim_contacts] after settle {SETTLE_STEPS} + 2 x {N_STEPS} replay "
                  f"steps against phase 45's full preset: largest root gap {root:.3e} mm, "
                  f"largest COM gap {com.max().item():.3e} mm (mean {com.mean().item():.3e}); "
                  f"JAX's docstring claims < {TRIM_CLAIM_MM} mm: "
                  f"{'within' if com.max().item() < TRIM_CLAIM_MM else 'NOT within'}")
    return counts


def gate_reasons(model) -> str:
    """What K2's gate weighs on a model's size: the walk tables' indices and
    the scratch rows in shared memory."""
    from flygym_tpu_torch.ops import megastep

    st = megastep._Static(model)
    layout = megastep.scratch_layout(model)
    return (f"{len(st.pair_keys)} Hessian entries and {st.ncand} candidates, the walk indices "
            f"under 32768; scratch {layout['n_scratch']} floats per world, "
            f"{4 * layout['n_shared']} bytes of the {megastep.SHARED_LIMIT} a block may use in "
            f"shared memory, {layout['n_global']} floats in global memory, "
            f"{layout['blocks_per_sm']} blocks per SM")


def phase_all_biological(fly, world) -> dict:
    """Phase 47: the fly with every biological joint (nv 132) at N_WORLDS on
    the path the gate picks: a settle and a timed rollout at the neutral
    targets; K2 against its plain version where the gate takes it."""
    import numpy as np
    import torch

    from flygym_tpu_torch import BatchSimulation
    from flygym_tpu_torch.ops import megastep

    compiled = world.compiled
    model = compiled.model
    supported = megastep.megastep_supported(model)
    try:
        why = gate_reasons(model)
    except (ValueError, NotImplementedError) as e:
        why = f"{type(e).__name__}: {e}"
    path = "K2" if supported else "the engine step (K1/K1b): the gate refuses K2"
    print(f"[all biological] nv {model.nv}, nu {model.nu}, ncand {model.ncand}: the path is "
          f"{path} ({why})")
    sim = BatchSimulation(compiled, N_WORLDS)
    check(sim.megastep == supported, "the simulation's path is not the gate's")
    sim.set_leg_adhesion_states(fly.name, np.ones(6, np.float32))
    reset_counts()
    sim.rollout(None, SETTLE_STEPS, record_trajectory=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.rollout(None, N_STEPS, record_trajectory=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    n = SETTLE_STEPS + N_STEPS
    want = ({"megastep": SETTLE_STEPS + N_STEPS // MEGASTEP_K, "tree_ldl_factor": 0,
             "tree_ldl_solve": 0} if supported else
            {"megastep": 0, "tree_ldl_factor": n, "tree_ldl_solve": 2 * n})
    for key, value in want.items():
        check(counts[key] == value, f"all biological: {key} launches {counts[key]} != {value}")
    st = sim.state
    for name in ("qpos", "qvel", "xpos", "contact_sensordata"):
        check(bool(torch.isfinite(getattr(st, name)).all()), f"all biological: {name} not finite")
    z = st.qpos[:, 2]
    print(f"[all biological] {N_WORLDS} worlds: settle {SETTLE_STEPS} + timed {N_STEPS} steps; "
          f"launches {counts}; root z {z.min().item():.4f}-{z.max().item():.4f} mm; "
          f"{N_STEPS * N_WORLDS / wall:.0f} world-steps/s on {card_line()}")
    if supported:
        held = st.map(lambda x: x.clone())
        k2_against_plain(
            "all biological kernel", sim.model,
            lambda fn, n_, k, seed: (held.map(lambda x: x[:n_].clone()),
                                     held.ctrl[:n_].expand((k, n_, model.nu)).clone(), None),
            checks=((N_WORLDS, 1),), timed=False)
    return counts


def phase_composed_against_files(composed: dict) -> None:
    """Phase 47: the tethered and the blocks-terrain worlds the port
    composed, each against its file and in one K2 launch at N_WORLDS
    against K2 built for the loaded file, on the same inputs."""
    from flygym_tpu_torch import load_compiled
    from flygym_tpu_torch.compose.bridge import (
        TERRAIN_FLY, TETHERED_FLY, TETHERED_GOLDEN, load_actuator_golden, load_terrain_golden)
    from flygym_tpu_torch.demo.benchmark import GOLDEN_TOLERANCE
    from flygym_tpu_torch.ops import megastep

    for name, path in (("tethered_fly", TETHERED_FLY), ("terrain_fly", TERRAIN_FLY)):
        world = composed[name][1]
        parted = compile_gaps(world, path)
        mine, loaded = world.compiled, load_compiled(path)
        m_mine, m_file = mine.model.to("cuda"), loaded.model.to("cuda")
        fn_mine, fn_file = megastep.make_megastep(m_mine, 1), megastep.make_megastep(m_file, 1)
        if name == "tethered_fly":
            golden = load_actuator_golden(TETHERED_GOLDEN)
            state, _seq = actuator_inputs(m_file, golden, N_WORLDS, 1, 5)
            planes = None
        else:
            state, _seq = terrain_inputs(loaded, m_file, load_terrain_golden(), N_WORLDS, 1, 5)
            planes = fn_file.sample_planes(state)
        reset_counts()
        got, want = fn_mine(state, planes), fn_file(state, planes)
        launches = read_counts()["megastep"]
        check(launches == 2, f"{name}: {launches} K2 launches, not 2")
        gaps = {f: (getattr(got, f) - getattr(want, f)).abs().max().item()
                for f in ("qpos", "qvel", "qacc", "xpos", "actuator_force")
                if getattr(want, f).numel()}
        same_header = megastep.model_header(mine.model)[0] == megastep.model_header(loaded.model)[0]
        print(f"[composed {name}] against the file: bit-equal but "
              f"{', '.join(parted) or 'none'}; K2 headers {'equal' if same_header else 'differ'}; "
              f"one launch at B={N_WORLDS} each, max|composed - file|: "
              + ", ".join(f"{f} {g:.2e}" for f, g in gaps.items()))
        if same_header:
            check(all(g == 0 for g in gaps.values()), f"{name}: one header, outputs differ")
        check(gaps["qpos"] <= GOLDEN_TOLERANCE["qpos"] and gaps["qvel"] <= GOLDEN_TOLERANCE["qvel"],
              f"{name}: the composed world parts from its file's beyond GOLDEN_TOLERANCE")


def phase_mjcf(world) -> None:
    """Phase 48: the benchmark world's MJCF against the CPU's, and the
    viewer without MuJoCo."""
    import hashlib
    import importlib.util

    from flygym_tpu_torch.render import launch_interactive_viewer

    t0 = time.perf_counter()
    xml = world.spec.to_mjcf_xml()
    digest = hashlib.sha256(xml.encode()).hexdigest()
    print(f"[mjcf] the benchmark world: {len(xml)} characters in "
          f"{time.perf_counter() - t0:.2f} s, SHA-256 {digest} (the CPU's {MJCF_SHA256})")
    check(digest == MJCF_SHA256, "the MJCF differs from the CPU's")
    if importlib.util.find_spec("mujoco") is not None:
        print("[mjcf] MuJoCo is installed here; the viewer is not launched")
        return
    try:
        launch_interactive_viewer(world)
    except ImportError as e:
        check("mujoco" in str(e), f"the viewer's ImportError does not name mujoco: {e}")
        print(f"[mjcf] launch_interactive_viewer without MuJoCo: ImportError: {e}")
    else:
        check(False, "launch_interactive_viewer ran without MuJoCo")


# ---------------------------------------------------------------------------
# Phases 49-51: gradients through the step
# ---------------------------------------------------------------------------


def grad_work(tables, B: int) -> tuple:
    """Operations and bytes of the Function's backward at B worlds: K1b's
    adjoint solve and gH on the envelope (two products, a sum, a negation
    and a scale per entry); L's chain entries, d, g and x read, gb and the
    dense gH written (fp32)."""
    nv, n_chain, n_env = tables.nv, tables.n_chain, tables.n_env
    return (B * (4 * n_chain + nv + 5 * n_env),
            4 * B * (n_chain + 3 * nv + nv + nv * nv))


def rel_gap(got, want) -> float:
    return ((got - want).abs().max() / want.abs().max()).item()


def expect_refusal(fn, what: str) -> None:
    """``fn`` must raise the kernels' refusal of an input that requires grad."""
    try:
        fn()
    except RuntimeError as e:
        check("would cut the graph" in str(e), f"{what}: another error: {e}")
        print(f"[grad kernels] {what}: raises ({str(e)[:60]}...)")
        return
    check(False, f"{what}: ran on an input that requires grad")


def phase_grad_kernels(model, env_compiled) -> dict:
    """Phase 49: K1 and K1b under autograd at N_WORLDS, and the kernels'
    refusals of inputs that require grad."""
    import torch

    from flygym_tpu_torch.compose.bridge import load_golden
    from flygym_tpu_torch.engine import linalg
    from flygym_tpu_torch.ops import ldl
    from flygym_tpu_torch.ops import retina as rk
    from flygym_tpu_torch.ops.megastep import make_megastep
    from flygym_tpu_torch.vision import Retina

    tables = model.ldl
    H, b = ldl.sample_problems(model, N_WORLDS, seed=49)
    w = torch.randn(b.shape, generator=torch.Generator().manual_seed(49)).to(b.device)
    L, d = ldl.tree_ldl_factor(tables, H)
    Hg, bg = H.clone().requires_grad_(True), b.clone().requires_grad_(True)
    Hp, bp = H.clone().requires_grad_(True), b.clone().requires_grad_(True)

    def fwd():
        return ldl.tree_ldl_solve_grad(tables, Hg, L, d, bg)

    def fwd_bwd():
        return torch.autograd.grad((fwd() * w).sum(), (Hg, bg))

    def plain_fwd():
        return linalg.tree_ldl_solve(tables, *linalg.tree_ldl_factor(tables, Hp), bp)

    def plain_fwd_bwd():
        return torch.autograd.grad((plain_fwd() * w).sum(), (Hp, bp))

    reset_counts()
    x = fwd()
    gH, gb = torch.autograd.grad((x * w).sum(), (Hg, bg))
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"[grad kernels] one forward and backward at B={N_WORLDS}: launches {counts}")
    check(counts["tree_ldl_factor"] == 0 and counts["tree_ldl_solve"] == 1
          and counts["tree_ldl_solve_backward"] == 1, f"launches {counts}")
    same = torch.equal(x.detach(), ldl.tree_ldl_solve(tables, L, d, b))
    print(f"[grad kernels] the Function's forward equal to the wrapper's: {same}")
    check(same, "the Function's forward differs from tree_ldl_solve")
    pH, pb = plain_fwd_bwd()
    gaps = {"gH": rel_gap(gH, pH), "gb": rel_gap(gb, pb)}
    err = (gb - pb).abs().max().item()
    i, a = tables.env_index
    mask = torch.zeros(gH.shape[1:], dtype=torch.bool, device=gH.device)
    mask[i, a] = True
    print(f"[grad kernels] against autograd through the plain versions on the card: "
          f"max|gH gap| / max|gH| {gaps['gH']:.3e} (max|gH| {pH.abs().max().item():.3e}), "
          f"max|gb gap| / max|gb| {gaps['gb']:.3e} (max|gb gap| {err:.3e}); bar "
          f"{GRAD_KERNEL_BAR}; gH off the envelope: {int((gH[:, ~mask] != 0).sum())} entries")
    check(max(gaps.values()) <= GRAD_KERNEL_BAR, f"gradient gaps {gaps}")
    check(bool(torch.isfinite(gH).all() and torch.isfinite(gb).all()), "gradients not finite")
    check(not bool(gH[:, ~mask].any()), "gH off the entries K1 reads")

    expect_refusal(lambda: ldl.tree_ldl_factor(tables, Hg), "K1 given H that requires grad")
    expect_refusal(lambda: ldl.tree_ldl_solve(tables, L, d, bg),
                   "K1b given b that requires grad")
    state = load_golden()["state"].map(lambda t: t[:4].to("cuda"))
    k2 = make_megastep(model, 1)
    expect_refusal(lambda: k2(replace(state, ctrl=state.ctrl.clone().requires_grad_(True))),
                   "K2 given ctrl that requires grad")
    env_model = env_compiled.model.to("cuda")
    rt = rk.RetinaTables(env_model, Retina.for_compiled(env_compiled))
    st = env_compiled.initial_state.to("cuda")
    expect_refusal(lambda: rk.launch_retina(rt, rk.pack_rows(
        rt, st.xpos.clone().requires_grad_(True), st.xquat)), "K3 given poses that require grad")

    t_fwd = time_ms(fwd, TIMED_LAUNCHES)
    t_both = time_ms(fwd_bwd, TIMED_LAUNCHES)
    t_plain_fwd = time_ms(plain_fwd, TIMED_LAUNCHES)
    t_plain_both = time_ms(plain_fwd_bwd, TIMED_LAUNCHES)
    bound = bound_ms(*grad_work(tables, N_WORLDS))
    back, plain_back = t_both - t_fwd, t_plain_both - t_plain_fwd
    print(f"[grad kernels] at B={N_WORLDS} on {card_line()}: the Function's forward "
          f"{t_fwd:.4f} ms, forward and backward {t_both:.4f} ms (backward {back:.4f} ms: one "
          f"K1b launch and gH); through the plain versions: forward (factor and solve) "
          f"{t_plain_fwd:.4f} ms, forward and backward {t_plain_both:.4f} ms (backward "
          f"{plain_back:.4f} ms); the backward's bound {bound[0]:.4f} ms ({bound[1]}), "
          f"{back / bound[0]:.1f}x it")
    return {"err": err, "ms": back, "plain_ms": plain_back, "bound": bound,
            "forward_ms": t_fwd, "forward_backward_ms": t_both}


class PlainLdlCalls:
    """Counts calls of the plain tree LDL (``engine/linalg.py``) while on:
    on the card's gradient path there must be none."""

    def __enter__(self):
        from flygym_tpu_torch.engine import linalg

        self.calls, self.saved = 0, (linalg.tree_ldl_factor, linalg.tree_ldl_solve)

        def counted(fn):
            def call(*args):
                self.calls += 1
                return fn(*args)
            return call

        linalg.tree_ldl_factor, linalg.tree_ldl_solve = map(counted, self.saved)
        return self

    def __exit__(self, *exc):
        from flygym_tpu_torch.engine import linalg

        linalg.tree_ldl_factor, linalg.tree_ldl_solve = self.saved


class PlainLdlRoute:
    """The engine step's contact solve through the plain tree LDL under
    autograd on the card (the JAX package's differentiable route), to hold
    the kernels' gradients against it."""

    def __enter__(self):
        from flygym_tpu_torch.engine import contact, linalg

        self.saved = contact._factor, contact._solve
        contact._factor = lambda model, H: linalg.tree_ldl_factor(model.ldl, H)
        contact._solve = lambda model, H, L, d, b: linalg.tree_ldl_solve(model.ldl, L, d, b)
        return self

    def __exit__(self, *exc):
        from flygym_tpu_torch.engine import contact

        contact._factor, contact._solve = self.saved


def fly_grads(model, state, n_steps: int) -> tuple:
    """The golden's benchmark-fly loss (scripts/export_grad_golden.py) and
    its gradients with respect to ctrl and qvel."""
    import torch

    from flygym_tpu_torch.engine.step import step

    ctrl = state.ctrl.clone().requires_grad_(True)
    qvel = state.qvel.clone().requires_grad_(True)
    s = replace(state, ctrl=ctrl, qvel=qvel)
    for _ in range(n_steps):
        s = step(model, s)
    loss = (s.qpos[0, 0] + s.qpos[0, 2] + 1e-3 * s.qvel.sum()
            + 1e-4 * s.contact_sensordata.sum())
    g_ctrl, g_qvel = torch.autograd.grad(loss, (ctrl, qvel))
    return loss.detach(), g_ctrl[0], g_qvel[0]


def phase_grad_step(compiled) -> dict:
    """Phase 50: the capsule's rollout, the benchmark fly's steps and
    example 10 on the card; returns example 10's launch counts."""
    import numpy as np
    import torch

    from flygym_tpu_torch.compose.bridge import load_golden
    from flygym_tpu_torch.demo import gradient_optimization as go
    from flygym_tpu_torch.engine.step import step

    with np.load(GRAD_GOLDEN) as g:
        golden = {k: torch.from_numpy(g[k]) for k in g.files}
    c = go.capsule_world()
    model, state = c.model.to("cuda"), c.initial_state.to("cuda")
    qvel0 = golden["qvel0"][None].to("cuda")
    n = int(golden["n_steps"])

    reset_counts()
    with PlainLdlCalls() as plain:
        t0 = time.perf_counter()
        v = qvel0.clone().requires_grad_(True)
        loss = go.capsule_loss(model, state, v, n)
        (g,) = torch.autograd.grad(loss, v)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    counts = read_counts()
    grav = model.gravity.clone().requires_grad_(True)
    (gg,) = torch.autograd.grad(go.capsule_loss(replace(model, gravity=grav), state, qvel0, n),
                                grav)
    gaps = {"qvel0": rel_gap(g[0].cpu(), golden["grad_qvel0"]),
            "gravity": rel_gap(gg.cpu(), golden["grad_gravity"])}
    print(f"[grad capsule] {n}-step rollout: loss {loss.item():.7f} (JAX {golden['loss'].item():.7f}); "
          f"grad qvel0 {g[0].tolist()}, gravity {gg.tolist()}; forward and backward {seconds:.3f} s "
          f"on {card_line()}; launches {counts}; plain tree-LDL calls {plain.calls}")
    print(f"[grad capsule] against the JAX golden: max gap / max|g| qvel0 {gaps['qvel0']:.3e}, "
          f"gravity {gaps['gravity']:.3e}; bar {GRAD_STEP_BAR}")
    check(counts["tree_ldl_factor"] == n
          and counts["tree_ldl_solve"] == counts["tree_ldl_solve_backward"]
          == n * max(model.solver_iterations, 1), f"capsule launches {counts}")
    check(plain.calls == 0, f"{plain.calls} plain tree-LDL calls on the capsule's path")
    check(max(gaps.values()) <= GRAD_STEP_BAR, f"capsule gradient gaps {gaps}")
    check(bool(torch.isfinite(gg).all()) and gg[2].item() != 0.0, f"gravity gradient {gg}")
    with torch.no_grad():
        for i in golden["fd_index"].tolist():
            e = torch.zeros_like(qvel0)
            e[0, i] = float(golden["fd_eps"])
            fd = (go.capsule_loss(model, state, qvel0 + e, n)
                  - go.capsule_loss(model, state, qvel0 - e, n)).item() / (2 * float(golden["fd_eps"]))
            print(f"[grad capsule] qvel0[{i}]: gradient {g[0, i].item():.6e}, central difference "
                  f"{fd:.6e} (the golden's {golden['fd_qvel0'][golden['fd_index'] == i].item():.6e})")
            check(abs(g[0, i].item() - fd) < FD_BAR * max(abs(fd), 1e-3),
                  f"qvel0[{i}]: gradient {g[0, i].item()} against {fd}")
        outs = []
        for diff in (True, False):
            s = replace(state, qvel=qvel0)
            for _ in range(n):
                s = step(replace(model, differentiable=diff), s)
            outs.append(s.qpos)
        print(f"[grad capsule] forward with differentiable on and off bit-equal: "
              f"{torch.equal(*outs)}")
        check(torch.equal(*outs), "the forward differs with differentiable on and off")

    fly_model = replace(compiled.model.to("cuda"), differentiable=True)
    fly_state = load_golden()["state"].map(lambda t: t[:1].to("cuda"))
    fn = int(golden["fly.n_steps"])
    reset_counts()
    t0 = time.perf_counter()
    kernel = fly_grads(fly_model, fly_state, fn)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    with PlainLdlRoute():
        plain_grads = fly_grads(fly_model, fly_state, fn)
    fly_gaps = {"kernels vs plain, ctrl": rel_gap(kernel[1], plain_grads[1]),
                "kernels vs plain, qvel": rel_gap(kernel[2], plain_grads[2]),
                "kernels vs JAX, ctrl": rel_gap(kernel[1].cpu(), golden["fly.grad_ctrl"]),
                "kernels vs JAX, qvel": rel_gap(kernel[2].cpu(), golden["fly.grad_qvel"]),
                "plain vs JAX, ctrl": rel_gap(plain_grads[1].cpu(), golden["fly.grad_ctrl"]),
                "plain vs JAX, qvel": rel_gap(plain_grads[2].cpu(), golden["fly.grad_qvel"])}
    print(f"[grad fly] the benchmark fly at B=1, {fn} steps from its settled world 0: loss "
          f"{kernel[0].item():.7f} (plain {plain_grads[0].item():.7f}, JAX "
          f"{golden['fly.loss'].item():.7f}); forward and backward {seconds:.3f} s on "
          f"{card_line()}; launches {counts}")
    print("[grad fly] max gap / max|g|: " + ", ".join(f"{k} {v:.3e}" for k, v in fly_gaps.items())
          + f"; bar {GRAD_STEP_BAR}")
    check(counts["tree_ldl_solve_backward"] == counts["tree_ldl_solve"] > 0, f"fly launches {counts}")
    check(max(fly_gaps.values()) <= GRAD_STEP_BAR, f"fly gradient gaps {fly_gaps}")

    sn = int(golden["stance.n_steps"])
    stance, _offset0 = go.stance_loss(sn, "cuda")
    for j, offset in enumerate(golden["stance.offset"]):
        x = offset.to("cuda").requires_grad_(True)
        val, lean, z = stance(x)
        (gs,) = torch.autograd.grad(val, x)
        value_gaps = {k: abs(v.item() - golden[f"stance.{k}"][j].item())
                      / abs(golden[f"stance.{k}"][j].item())
                      for k, v in (("loss", val), ("lean", lean), ("z", z))}
        grad_gap = rel_gap(gs.cpu(), golden["stance.grad"][j])
        print(f"[example 10 golden] offset {j} ({'zero' if j == 0 else 'seeded'}), {sn} steps: "
              f"loss {val.item():.7f} (JAX {golden['stance.loss'][j].item():.7f}); relative gaps "
              + ", ".join(f"{k} {v:.3e}" for k, v in value_gaps.items())
              + f", gradient {grad_gap:.3e} of max|g|; bar {GRAD_STEP_BAR}")
        check(max(*value_gaps.values(), grad_gap) <= GRAD_STEP_BAR,
              f"example 10 against JAX at offset {j}: {value_gaps}, gradient {grad_gap}")

    reset_counts()
    with PlainLdlCalls() as plain:
        t0 = time.perf_counter()
        history = go.main(**EXAMPLE_10, device="cuda")
        seconds = time.perf_counter() - t0
    counts = read_counts()
    steps = EXAMPLE_10["n_steps"] * EXAMPLE_10["n_iters"]
    solves = steps * max(compiled.model.solver_iterations, 1)
    # The loss reads the last state's xpos, the pose before that step's
    # integration: the last step's solves do not reach it, and autograd
    # runs no backward for them.
    back = solves - EXAMPLE_10["n_iters"] * max(compiled.model.solver_iterations, 1)
    print(f"[example 10] {EXAMPLE_10['n_iters']} iterations of {EXAMPLE_10['n_steps']} steps "
          f"in {seconds:.2f} s on {card_line()}: per iteration "
          + ", ".join(f"loss {h['loss']:+.5f} in {h['seconds']:.3f} s" for h in history)
          + f"; launches {counts}; plain tree-LDL calls {plain.calls}")
    check(plain.calls == 0, f"{plain.calls} plain tree-LDL calls on example 10's path")
    check(counts["tree_ldl_factor"] == steps and counts["tree_ldl_solve"] == solves
          and counts["tree_ldl_solve_backward"] == back and counts["megastep"] == 0,
          f"example 10's launches {counts}, expected {steps} K1, {solves} K1b and {back} "
          f"backward K1b")
    check(all(np.isfinite([h["loss"], h["lean"], h["z"]]).all() for h in history),
          "example 10: a loss is not finite")
    return counts


def phase_pose_conversion() -> None:
    """Phase 51: the pose conversion YPR -> PRY on LEGS_ONLY on the card."""
    import numpy as np
    import torch

    from flygym_tpu_torch.anatomy import AxisOrder, JointPreset, Skeleton
    from flygym_tpu_torch.compose import KinematicPosePreset
    from flygym_tpu_torch.compose.fly import Fly
    from flygym_tpu_torch.utils.pose_conversion import (convert_pose_axis_order, graphed_backward,
                                                        pose_cost)

    pose = KinematicPosePreset.NEUTRAL.get_pose_by_axis_order(AxisOrder.YPR)
    t0 = time.perf_counter()
    converted = convert_pose_axis_order(pose, AxisOrder.PRY, joint_preset=JointPreset.LEGS_ONLY,
                                        device="cuda")
    seconds = time.perf_counter() - t0

    def fk(p, order):
        fly = Fly()
        fly.add_joints(Skeleton(axis_order=order, joint_preset=JointPreset.LEGS_ONLY),
                       neutral_pose=p)
        _model, state = fly.compile()
        return state.xpos[0].numpy()

    err = float(np.abs(fk(pose, AxisOrder.YPR) - fk(converted, AxisOrder.PRY)).max())
    print(f"[pose conversion] YPR -> PRY on LEGS_ONLY, 2000 Adam steps on the card: "
          f"{seconds:.2f} s on {card_line()}; largest body position gap {err:.4f} mm "
          f"(bar {POSE_BAR_MM})")
    check(converted.axis_order is AxisOrder.PRY and err < POSE_BAR_MM,
          f"pose conversion: gap {err} mm")

    # The fit's CUDA graph against the eager cost and backward at seeded qpos.
    ref, fitted = Fly(), Fly()
    ref.add_joints(Skeleton(axis_order=AxisOrder.YPR, joint_preset=JointPreset.LEGS_ONLY),
                   neutral_pose=pose)
    fitted.add_joints(Skeleton(axis_order=AxisOrder.PRY, joint_preset=JointPreset.LEGS_ONLY),
                      neutral_pose=pose)
    _m, ref_state = ref.compile()
    model = fitted.compile()[0].to("cuda")
    cost = pose_cost(model, ref_state.xpos[0].numpy(), ref_state.xquat[0].numpy())
    qpos = torch.zeros(model.nq, device="cuda", requires_grad=True)
    replay = graphed_backward(cost, qpos)
    gen = torch.Generator().manual_seed(0)
    gaps = []
    for _ in range(3):
        q = (torch.rand(model.nq, generator=gen) - 0.5).to("cuda")
        with torch.no_grad():
            qpos.copy_(q)
        replay()
        x = q.clone().requires_grad_(True)
        (want,) = torch.autograd.grad(cost(x), x)
        gaps.append(rel_gap(qpos.grad, want))
    print(f"[pose conversion] the fit's CUDA graph against the eager cost and backward at 3 "
          f"seeded qpos: max gap / max|g| {max(gaps):.3e} (bar {GRAD_KERNEL_BAR})")
    check(max(gaps) <= GRAD_KERNEL_BAR, f"the pose fit's graph: gaps {gaps}")


# Phase 52: K2's pow against the plain powf.
POWF_EXPONENTS = (0.25, 0.5, 0.8, 0.9, 1.0, 1.5, 3.0)
POWF_SAMPLES = 1 << 20
# Phases 55-56: example 13 at its own width (1024 envs x 100 env steps) and
# 10 of its 50 updates, the seconds per update their median; and at --small.
ES_FULL = dict(n_envs=1024, n_updates=10, episode_len=100)
ES_SMALL = dict(n_envs=64, n_updates=10, episode_len=25)


def phase_powf(model) -> None:
    """K2's ``ms_powf`` (the impedance's pow, ``ops/megastep.py:
    kernel_powf``, from ``model``'s build) against the plain ``powf`` on the
    same CUDA tensors and on the CPU, to the last bit: normal, tiny,
    subnormal (every exponent field 0, seeded mantissas) and zero x at
    exponents below and above 1; a subnormal x reads as 2^-150, so x^y is
    not 0 where y < ~0.84."""
    import torch

    from flygym_tpu_torch.engine import maths
    from flygym_tpu_torch.ops import megastep

    gen = torch.Generator().manual_seed(52)
    n = POWF_SAMPLES // 4
    sub = torch.randint(1, 1 << 23, (n,), generator=gen, dtype=torch.int32).view(torch.float32)
    x = torch.cat([torch.rand(n, generator=gen), torch.rand(n, generator=gen) * 2.0**-100, sub,
                   torch.rand(n, generator=gen) * 2.0**-120])
    x[:4] = torch.tensor([0.0, 2.0**-149, 2.0**-130, 1.0])
    xc = x.cuda()
    for y in POWF_EXPONENTS:
        yc = torch.full_like(xc, y)
        got = megastep.kernel_powf(model, xc, yc)
        plain_card = maths.powf(xc, yc)
        plain_cpu = maths.powf(x, torch.full_like(x, y))
        check(torch.equal(got, plain_card), f"powf y={y}: K2's ms_powf differs from the plain "
              f"powf on the card in {int((got != plain_card).sum())} of {x.numel()}")
        check(torch.equal(got.cpu(), plain_cpu), f"powf y={y}: K2's ms_powf differs from the "
              f"plain powf on the CPU")
        nonzero = int((got[2 * n:3 * n] != 0).sum())
        check((nonzero == n) == (y < 0.84), f"powf y={y}: {nonzero} of {n} subnormal x nonzero")
        print(f"[powf] y={y}: K2's ms_powf equal to the plain powf (card and CPU) over "
              f"{x.numel()} x; subnormal x giving nonzero {nonzero} of {n}")


def phase_composed_env(env_compiled) -> tuple:
    """Config 5 on the env that composes its own world
    (``demo/multimodal_navigation.py:build_env``): its tables against
    ``env_fly.npz``'s; phase 8's path at N_WORLDS; and its 8-world K2 path
    against the ``.npz`` env's from the golden's settled state, 5 env steps
    (within GOLDEN_TOLERANCE: the composed compile's ``can_invweight`` parts
    from the file's in the last bits). Returns phase 8's counts and time."""
    import numpy as np
    import torch

    from flygym_tpu_torch.compose.bridge import load_env_golden
    from flygym_tpu_torch.demo import multimodal_navigation as nav
    from flygym_tpu_torch.demo.benchmark import GOLDEN_TOLERANCE
    from flygym_tpu_torch.env import VectorFlyEnv
    from flygym_tpu_torch.olfaction import OdorField

    t0 = time.perf_counter()
    env = nav.build_env()
    print(f"[env composed] composed, compiled and built on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    meta = env_compiled.env
    for key in ("act_ids", "adh_ids", "qpos_adrs", "qvel_adrs", "sensor_slots", "tip_bodies"):
        check(getattr(env, f"_{key}").tolist() == meta[key], f"env composed: {key} differs")
    check(env._root_body == meta["root_body"] and [env.retina.left_eye_body,
          env.retina.right_eye_body] == meta["eye_bodies"], "env composed: root or eyes differ")
    counts, wall = phase_env(env, label="env composed")

    golden = load_env_golden()
    file_env = VectorFlyEnv(env_compiled, enable_vision=True,
                            odor_field=OdorField.for_compiled(env_compiled))
    runs = {}
    for name, e in (("composed", env), ("file", file_env)):
        step = e.make_batched_step()
        states, rec = golden["state"].to("cuda"), []
        for i in range(golden["joints"].shape[0]):
            action = {k: torch.as_tensor(golden[k][i]).cuda() for k in ("joints", "adhesion")}
            states, obs, _r, _d, _ = step(states, action)
            rec.append((states.qpos.cpu().numpy(), states.qvel.cpu().numpy(),
                        obs["vision"].cpu().numpy()))
        runs[name] = rec
    gaps = {key: max(float(np.abs(a[j] - b[j]).max()) for a, b in zip(runs["composed"],
                                                                      runs["file"]))
            for j, key in enumerate(("qpos", "qvel", "vision"))}
    print(f"[env composed] 8 worlds x {len(runs['file'])} env steps on K2 against the .npz "
          f"env's: max gaps " + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items()))
    for key in ("qpos", "qvel"):
        check(gaps[key] <= GOLDEN_TOLERANCE[key], f"env composed {key}: {gaps[key]:.3e}")
    return counts, wall


def phase_rl_examples() -> dict:
    """Example 06's batched half (``VectorFlyEnv()``, one env step) and
    example 09 (3 env steps with vision and odor) at N_WORLDS: launches,
    finite observations, seconds."""
    import torch

    from flygym_tpu_torch.demo import multimodal_navigation as nav
    from flygym_tpu_torch.demo import rl_environment

    out = {}
    for label, fn, want in (
        ("example 06", lambda: rl_environment.vector_half(N_WORLDS),
         {"megastep": 1, "retina": 0}),
        ("example 09", lambda: nav.main(N_WORLDS),
         {"megastep": 3, "retina": 3}),
    ):
        reset_counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
        for name, n in {**want, "tree_ldl_factor": 0, "tree_ldl_solve": 0}.items():
            check(counts[name] == n, f"{label}: {name} launches {counts[name]} != {n}")
        for key, v in res["obs"].items():
            check(bool(torch.isfinite(v).all()), f"{label}: {key} not finite")
        check(bool(torch.isfinite(res["rewards"]).all()), f"{label}: rewards not finite")
        print(f"[{label}] {N_WORLDS} worlds in {seconds:.2f} s with the env's build; "
              f"launches {counts}")
        out[label] = counts
    return out


def phase_es(label: str, size: dict, learn: bool) -> dict:
    """Example 13 (``demo/rl_training_es.py:train``) at ``size`` on the
    card: seconds per update, the curve, one K = 10 K2 launch per env step
    and no tree-LDL launch; with ``learn``, JAX's learning criterion
    (``tests/examples/test_rl_training.py``: the last two updates' mean
    reward above twice the first two's)."""
    import numpy as np

    from flygym_tpu_torch.demo import rl_training_es

    reset_counts()
    timings = []
    t0 = time.perf_counter()
    curve, _theta = rl_training_es.train(**size, verbose=False, timings=timings)
    total = time.perf_counter() - t0
    counts = read_counts()
    n_steps = size["n_updates"] * size["episode_len"]
    for name, n in {"megastep": n_steps, "retina": 0, "tree_ldl_factor": 0,
                    "tree_ldl_solve": 0}.items():
        check(counts[name] == n, f"{label}: {name} launches {counts[name]} != {n}")
    check(bool(np.isfinite(curve).all()) and len(curve) == size["n_updates"],
          f"{label}: the curve is not finite")
    t = np.asarray(timings)
    fifth = max(len(curve) // 5, 1)
    print(f"[{label}] {size}: {total:.2f} s in all; seconds per update first {t[0]:.3f}, "
          f"median {np.median(t):.3f}, mean of the rest {t[1:].mean() if len(t) > 1 else t[0]:.3f}"
          f" ({size['n_envs'] * size['episode_len'] * 10 / np.median(t):.0f} world-steps/s) on "
          f"{card_line()}; launches {counts}")
    print(f"[{label}] mean reward first fifth {curve[:fifth].mean():+.5f} -> last fifth "
          f"{curve[-fifth:].mean():+.5f}; curve {np.round(curve, 5).tolist()}")
    if learn:
        first, last = curve[:2].mean(), curve[-2:].mean()
        check(last > 2.0 * first, f"{label}: ES did not learn ({first:+.5f} -> {last:+.5f})")
        print(f"[{label}] JAX's learning criterion met: {first:+.5f} -> {last:+.5f} "
              f"({last / first:.2f}x)")
    return {"counts": counts, "seconds": t, "curve": curve}


# ---------------------------------------------------------------------------
# Phases 57-61: two flies at every contact setting JAX's K2 takes
# ---------------------------------------------------------------------------


def compose_two_flies(condim: int = 3, terrain: bool = False):
    """Example 11's world at ``condim`` or on the blocks terrain, composed
    and compiled by the port on the CPU (``demo/two_flies.py``)."""
    from flygym_tpu_torch.demo.two_flies import make_two_fly_world

    world = make_two_fly_world(condim=condim, terrain=terrain)
    world.compile()
    return world


def phase_pair_condims(pair_worlds: dict) -> dict:
    """Phase 57: K2 with pair rows at condim 1, 4 and 6 against its plain
    version at PAIR_CHECK_WORLDS from the condim-6 golden's settled worlds
    with seeded root and joint noise: one K = 1 launch at condim 1 and 4,
    at condim 6 one K = MEGASTEP_K launch (phase 58's main path: the warm
    starts and the torsion and rolling rows across steps) against the
    chain of plain steps, and its K = 1 and K = 8 launches timed at
    N_WORLDS with their bounds. Returns each condim's
    ``k2_against_plain``."""
    from flygym_tpu_torch.compose.bridge import TWOFLY_CONDIM6_GOLDEN, load_pair_variant_golden

    golden = load_pair_variant_golden(TWOFLY_CONDIM6_GOLDEN)
    out = {}
    for c in PAIR_CONDIMS:
        model = pair_worlds[c].model.to("cuda")
        at = (PAIR_CHECK_WORLDS, MEGASTEP_K if c == 6 else 1)
        out[c] = k2_against_plain(
            f"pairs condim {c} kernel", model,
            lambda fn, n, k, seed, model=model: (*twofly_inputs(model, golden, n, k, seed), None),
            lambda state, _p, model=model: f"worlds with an active pair row "
                                           f"{active_pair_share(model, state):.4f}",
            checks=(at,), timed=c == 6, entry_at=at)
        check(out[c]["err"] == 0.0, f"pairs condim {c}: K2 parts from its plain version")
    return out


def phase_pair_terrain(compiled) -> tuple:
    """Phase 59: example 11's flies on the blocks terrain with compressed pair
    rows. K2 against its plain version, one K = MEGASTEP_K launch (the
    rollout's) at PAIR_CHECK_WORLDS against the chain of plain steps (the
    golden's settled worlds with seeded noise, the joint sampler's planes
    and winners, both read for all K steps); the joint sampler on the card
    against the same sampler on the CPU; K2's and the sampler's times at
    N_WORLDS; the 800-step rollout from the drop at N_WORLDS (K2 100,
    plane and winner samples 100 each); the golden."""
    import torch

    from flygym_tpu_torch.compose.bridge import TWOFLY_TERRAIN_GOLDEN, load_pair_variant_golden
    from flygym_tpu_torch.engine import terrain
    from flygym_tpu_torch.ops import megastep

    golden = load_pair_variant_golden(TWOFLY_TERRAIN_GOLDEN)
    model = compiled.model.to("cuda")
    k2 = k2_against_plain(
        "pairs terrain kernel", model,
        lambda fn, n, k, seed: compressed_inputs(model, golden, n, k, seed, fn),
        lambda state, _a: f"worlds with an active compressed row "
                          f"{active_pair_share(model, state):.4f}",
        checks=((PAIR_CHECK_WORLDS, MEGASTEP_K),), timed=True,
        entry_at=(PAIR_CHECK_WORLDS, MEGASTEP_K))
    check(k2["err"] == 0.0, "pairs terrain: K2 parts from its plain version")
    fn = k2["fns"][1]
    state = twofly_inputs(model, golden, PAIR_CHECK_WORLDS, 1, 3)[0]
    card = fn.sample_planes(state)
    cpu = megastep.make_megastep(compiled.model).sample_planes(state.to("cpu"))
    st = fn.static
    planes, widx = megastep._split_aux(st, card)
    cplanes, cwidx = megastep._split_aux(st, cpu)
    gap = (planes.cpu() - cplanes).abs().max().item()
    differ = int((widx.cpu() != cwidx).sum().item())
    print(f"[pairs terrain] joint sampler at B={PAIR_CHECK_WORLDS}, card against CPU: planes "
          f"max gap {gap:.3e}, {differ} of {widx.numel()} winners differ; shape "
          f"{tuple(card.shape)} (4 x {st.ncand} plane rows, {len(st.pair_comp_groups)} winners)")
    check(gap <= PLANE_ATOL, f"pairs terrain: the card's planes part from the CPU's by {gap:.3e}")
    if differ:
        winners_near_tie(model, state, cwidx.cuda(), "pairs terrain", 0)
    big = twofly_inputs(model, golden, N_WORLDS, 1, 1)[0]
    k2["sample_ms"] = time_ms(lambda: fn.sample_planes(big), TIMED_LAUNCHES)
    print(f"[pairs terrain] joint sampler at B={N_WORLDS}: {k2['sample_ms']:.4f} ms per sample")
    terrain.reset_samples()
    counts, wall = phase_twofly(compiled, label="twofly terrain",
                                what="example 11 on the blocks terrain, compressed pair rows",
                                engine_steps=PAIR_ENGINE_STEPS)
    planes_sampled = terrain.samples["planes"]
    print(f"[twofly terrain] plane samples in the rollout and its engine path: {planes_sampled}")
    check(planes_sampled >= TWOFLY_STEPS // MEGASTEP_K,
          f"twofly terrain: {planes_sampled} plane samples")
    k8 = k2["times"][MEGASTEP_K][0]
    print(f"[twofly terrain] device busy share: "
          f"{100 * counts['megastep'] * k8 / (wall * 1e3):.1f}% "
          f"({counts['megastep']} launches x {k8:.3f} ms over {wall:.3f} s)")
    for megastep_ in (None, False):
        phase_twofly_golden(
            compiled, golden_path=TWOFLY_TERRAIN_GOLDEN, megastep=megastep_,
            label=f"twofly terrain golden {'engine' if megastep_ is False else 'megastep'}")
    return k2, counts


def phase_all_possible(compiled) -> tuple:
    """Phase 60: ``JointPreset.ALL_POSSIBLE`` (nv 210) at N_WORLDS through
    the default step: a timed ALL_POSSIBLE_STEPS rollout at the neutral
    targets (K = 8 launches); then K2 against its plain version, one K = 1
    launch at PAIR_CHECK_WORLDS from the rollout's end state moved by
    ``jitter`` (qpos and qvel, so that the worlds differ), and its K = 1
    and K = 8 launches timed at N_WORLDS with their bounds."""
    import numpy as np
    import torch

    from flygym_tpu_torch import BatchSimulation

    model = compiled.model
    print(f"[all possible] nv {model.nv}, nu {model.nu}, ncand {model.ncand}: "
          f"{gate_reasons(model)}")
    sim = BatchSimulation(compiled, N_WORLDS)
    check(sim.megastep, "ALL_POSSIBLE's default step is not the mega-step on the card")
    sim.set_leg_adhesion_states(compiled.fly_names[0], np.ones(6, np.float32))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    sim.rollout(None, ALL_POSSIBLE_STEPS, record_trajectory=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    want = {"megastep": ALL_POSSIBLE_STEPS // MEGASTEP_K, "tree_ldl_factor": 0,
            "tree_ldl_solve": 0}
    for key, value in want.items():
        check(counts[key] == value, f"all possible: {key} launches {counts[key]} != {value}")
    st = sim.state
    for name in ("qpos", "qvel", "xpos", "contact_sensordata"):
        check(bool(torch.isfinite(getattr(st, name)).all()), f"all possible: {name} not finite")
    z = st.qpos[:, 2]
    print(f"[all possible] {N_WORLDS} worlds: {ALL_POSSIBLE_STEPS} steps from the spawn in "
          f"{wall:.3f} s; launches {counts}; root z {z.min().item():.4f}-{z.max().item():.4f} mm; "
          f"{ALL_POSSIBLE_STEPS * N_WORLDS / wall:.0f} world-steps/s on {card_line()}")
    held = st.map(lambda x: x.clone())

    def inputs(_fn, n, k, seed):
        state = jitter(sim.model, held.map(lambda x: x[:n].clone()), seed, qvel_scale=0.1)
        return state, state.ctrl.expand((k, n, model.nu)).clone(), None

    k2 = k2_against_plain(
        "all possible kernel", sim.model, inputs,
        lambda state, _p: f"qpos spread over the worlds "
                          f"{(state.qpos - state.qpos[:1]).abs().max().item():.3e}",
        checks=((PAIR_CHECK_WORLDS, 1),), timed=True, entry_at=(PAIR_CHECK_WORLDS, 1))
    check(k2["err"] == 0.0, "all possible: K2 parts from its plain version")
    return k2, counts


def phase_two_flies_example(condim6_pairs) -> dict:
    """Phase 61: example 11 in torch (``demo/two_flies.main``) at N_WORLDS
    and at B = 1, and at B = 1 at condim 1 and 4 (phase 57's composed
    headers), its frame from ``bottom/trackcam`` as a PNG each; then the
    condim-6 world (``condim6_pairs``, phase 58's header) at B = 1: a
    TWOFLY_STEPS drop, then TWOFLY_STEPS more steps timed. Returns each
    run's counts by label."""
    import torch

    from flygym_tpu_torch import Simulation
    from flygym_tpu_torch.demo import two_flies

    out = {}
    frames = Path("outputs")
    runs = [("4096 worlds", {"n_worlds": N_WORLDS}), ("B=1", {})]
    runs += [(f"B=1, condim {c}", {"condim": c}) for c in PAIR_CONDIMS if c != 6]
    for label, kwargs in runs:
        reset_counts()
        t0 = time.perf_counter()
        r = two_flies.main(**kwargs, out=frames / f"11_two_flies_{len(out)}.png")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        check(counts["megastep"] == TWOFLY_STEPS // MEGASTEP_K and counts["tree_ldl_factor"] == 0,
              f"example 11 ({label}): launches {counts}")
        png = r["path"].read_bytes()
        check(png[:8] == b"\x89PNG\r\n\x1a\n" and r["frame"].shape == (240, 320, 3)
              and int(r["frame"].max()) > 0, f"example 11 ({label}): the frame")
        print(f"[example 11] {label}: main in {wall:.2f} s (compile, build, {TWOFLY_STEPS} steps, "
              f"the frame); K2 {counts['megastep']}; root z bottom {r['z_bottom']:.3f}, top "
              f"{r['z_top']:.3f} mm; frame {r['path']} ({len(png)} bytes)")
        out[label] = counts
    sim = Simulation(condim6_pairs)
    check(sim.megastep, "example 11 at condim 6, B = 1: not the mega-step")
    sim.set_leg_adhesion_states("bottom", torch.ones(6, device="cuda"))
    reset_counts()
    sim.rollout(None, TWOFLY_STEPS, record_trajectory=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.rollout(None, TWOFLY_STEPS, record_trajectory=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    check(counts["megastep"] == 2 * TWOFLY_STEPS // MEGASTEP_K,
          f"example 11 at condim 6, B = 1: launches {counts}")
    qpos = sim.state.qpos[0]
    lift = (qpos[sim.model.free_joints[1][1] + 2] - qpos[sim.model.free_joints[0][1] + 2]).item()
    check(lift > REST_GAP_MM, f"example 11 at condim 6, B = 1: the top root {lift:.3f} mm above")
    print(f"[example 11] B=1 at condim 6: the top root {lift:.3f} mm above the bottom one; "
          f"{TWOFLY_STEPS} more steps in {wall:.3f} s, {wall / TWOFLY_STEPS * 1e3:.4f} ms per step "
          f"(K = {MEGASTEP_K} launches) on {card_line()}")
    return out


STATE_FIELDS = ("qpos", "qvel", "ctrl", "act", "time", "qacc", "xpos", "xquat", "site_xpos",
                "actuator_force", "contact_sensordata")


def state_gaps(a, b) -> dict:
    """Each field's largest |a - b| (shapes must agree)."""
    return {f: (getattr(a, f) - getattr(b, f)).abs().max().item() if getattr(a, f).numel()
            else 0.0 for f in STATE_FIELDS}


def sharded_against_unsharded(label: str, compiled, state, n_steps: int, mesh,
                              megastep=None) -> tuple:
    """``rollout(None, n_steps)`` of ``state`` in a BatchSimulation over
    ``mesh``, and of each shard's block of worlds in an unsharded
    BatchSimulation of that block's size (the same batch, so the same
    library kernels); every shard's outputs and trajectory equal to its
    block's to the last bit or not, each field's largest gap, and the
    counts: the unsharded runs' summed, the sharded run's."""
    import torch

    from flygym_tpu_torch import BatchSimulation
    from flygym_tpu_torch.parallel import shard_world_axis

    def run(n, m, start):
        sim = BatchSimulation(compiled, n, mesh=m, megastep=megastep)
        sim.state = start
        traj = sim.rollout(None, n_steps)
        return sim, traj

    n_worlds = state.qpos.shape[0]
    reset_counts()
    sim, traj = run(n_worlds, mesh, state)
    torch.cuda.synchronize()
    cb = read_counts()
    got = zip(sim.shards, shard_world_axis(traj, mesh, dim=1))
    ca = {}
    equal, gaps = True, {}
    for block, (shard, rows) in zip(shard_world_axis(state, mesh), got):
        reset_counts()
        ref, ref_traj = run(n_worlds // mesh.size, None, block.map(torch.clone))
        torch.cuda.synchronize()
        ca = {k: ca.get(k, 0) + v for k, v in read_counts().items()}
        for k, v in state_gaps(ref.state, shard).items():
            gaps[k] = max(gaps.get(k, 0.0), v)
        gaps["qpos rows"] = max(gaps.get("qpos rows", 0.0), (ref_traj - rows).abs().max().item())
        equal = equal and all(torch.equal(getattr(ref.state, f), getattr(shard, f))
                              for f in STATE_FIELDS) and bool(torch.equal(ref_traj, rows))
        check(bool(torch.isfinite(ref.state.qpos).all()), f"{label}: state not finite")
    check(bool(torch.isfinite(sim.state.qpos).all()), f"{label}: sharded state not finite")
    print(f"[mesh] {label}, {n_worlds} worlds, {n_steps} steps: each of {mesh.size} shards equal "
          f"to an unsharded batch of its {n_worlds // mesh.size} worlds to the last bit: {equal} "
          f"(largest gap {max(gaps.values()):.3e}); counts unsharded {ca}, sharded {cb}")
    return equal, gaps, ca, cb


def phase_mesh(compiled, unsharded_end, unsharded_wall, terrain_compiled, full_compiled) -> dict:
    """Phase 62: worlds split over MESH_SHARDS shards of cuda:0
    (``parallel.make_world_mesh``; one card carries the mesh's dry run).

    1. The replay benchmark of phase 4 (``run_simulation(mesh=)``): K2 once
       per shard per launch (2 x 750), its end state equal to phase 4's
       ``unsharded_end`` to the last bit, its world-steps/s beside phase 4's
       (``unsharded_wall``).
    2. MESH_ROLLOUT steps (K = 8) of the terrain fly (planes sampled per
       shard) and of the default two-fly preset (winners per shard) from
       seeded noisy worlds at N_WORLDS, each shard against an unsharded
       batch of its block (``sharded_against_unsharded``): equal to the
       last bit, launches and samples as many.
    3. The engine path (K1 and K1b per shard) MESH_ENGINE_STEPS steps from
       the golden's settled worlds made to differ (``jitter``), each shard
       against an unsharded batch of its block: equal to the last bit (at
       the same batch cuBLAS takes the same kernels).
    4. ``save_state`` / ``load_state`` of the sharded replay (``put_like``
       onto the shards), equal to the last bit.
    5. Example 12's ``main`` (8 shards of 4 worlds on cuda:0): K2 8 + 8 x 50.

    Returns the counts of the sharded replay."""
    import torch

    from flygym_tpu_torch.compose.bridge import (
        TWOFLY_FULL_GOLDEN, load_golden, load_terrain_golden, load_twofly_golden)
    from flygym_tpu_torch.demo import multichip_scaling
    from flygym_tpu_torch.parallel import make_world_mesh
    from flygym_tpu_torch.utils import checkpoint

    mesh = make_world_mesh(["cuda:0"] * MESH_SHARDS)
    launches = SETTLE_STEPS + 2 * (N_STEPS // MEGASTEP_K)
    counts, wall, sim = phase_slice(
        compiled, label="mesh replay", megastep=None, settle=SETTLE_STEPS, steps=N_STEPS,
        want={"megastep": MESH_SHARDS * launches, "tree_ldl_factor": 0, "tree_ldl_solve": 0},
        return_sim=True, mesh=mesh)
    check(len(sim.shards) == MESH_SHARDS
          and all(s.qpos.shape[0] == N_WORLDS // MESH_SHARDS for s in sim.shards),
          f"mesh replay: shards {[tuple(s.qpos.shape) for s in sim.shards]}")
    end = sim.state
    equal = all(torch.equal(getattr(end, f), getattr(unsharded_end, f)) for f in STATE_FIELDS)
    check(equal, f"mesh replay: the end state parts from phase 4's: "
                 f"{state_gaps(end, unsharded_end)}")
    rate, rate1 = N_STEPS * N_WORLDS / wall, N_STEPS * N_WORLDS / unsharded_wall
    print(f"[mesh] the replay at {N_WORLDS} worlds on {MESH_SHARDS} shards of cuda:0: end state "
          f"equal to phase 4's unsharded one to the last bit; {rate:.0f} world-steps/s against "
          f"{rate1:.0f} unsharded ({rate / rate1:.4f}x) on {card_line()}")

    terrain_model = terrain_compiled.model.to("cuda")
    state = terrain_inputs(terrain_compiled, terrain_model, load_terrain_golden(), N_WORLDS, 1,
                           62)[0]
    ok, _gaps, ca, cb = sharded_against_unsharded("terrain fly, K = 8", terrain_compiled, state,
                                                  MESH_ROLLOUT, mesh)
    check(ok and cb["megastep"] == ca["megastep"] == MESH_SHARDS * MESH_ROLLOUT // MEGASTEP_K,
          "mesh: the terrain fly's sharded rollout")
    full_model = full_compiled.model.to("cuda")
    state = twofly_inputs(full_model, load_twofly_golden(TWOFLY_FULL_GOLDEN), N_WORLDS, 1, 62)[0]
    ok, _gaps, ca, cb = sharded_against_unsharded("the default two-fly preset, K = 8",
                                                  full_compiled, state, MESH_ROLLOUT, mesh)
    check(ok and cb["megastep"] == ca["megastep"] == MESH_SHARDS * MESH_ROLLOUT // MEGASTEP_K
          and cb["winners"] == ca["winners"] > 0,
          "mesh: the default two-fly preset's sharded rollout")

    state = jitter(compiled.model.to("cuda"), load_golden()["state"].map(
        lambda x: x[torch.arange(N_WORLDS) % 8].clone()).to("cuda"), 62, qvel_scale=0.1)
    equal, gaps, ca, cb = sharded_against_unsharded("the engine path", compiled, state,
                                                    MESH_ENGINE_STEPS, mesh, megastep=False)
    check(cb["tree_ldl_factor"] == ca["tree_ldl_factor"] == MESH_SHARDS * MESH_ENGINE_STEPS
          and cb["tree_ldl_solve"] == ca["tree_ldl_solve"] and cb["megastep"] == 0,
          "mesh: the engine path's launches")
    check(equal, f"mesh: the engine path's shards part from their unsharded blocks: {gaps}")

    path = Path("outputs") / "mesh_state.npz"
    want = [s.map(torch.clone) for s in sim.shards]
    sim.save_state(path)
    sim.reset()
    sim.load_state(path)
    check(all(torch.equal(getattr(a, f), getattr(b, f)) for a, b in zip(sim.shards, want)
              for f in STATE_FIELDS), "mesh: load_state did not restore the shards")
    put = checkpoint.put_like(checkpoint.load_state(path, device="cpu"), want)
    check([s.qpos.device for s in put] == list(mesh.devices), "mesh: put_like's devices")
    print(f"[mesh] save_state -> load_state (put_like onto {MESH_SHARDS} shards): equal to the "
          f"last bit")

    reset_counts()
    t0 = time.perf_counter()
    r = multichip_scaling.main()
    torch.cuda.synchronize()
    c12 = read_counts()
    n = r["sim"].mesh.size
    check(c12["megastep"] == n * (1 + 50) and tuple(r["traj"].shape[:2]) == (50, 4 * n),
          f"example 12: counts {c12}, trajectory {tuple(r['traj'].shape)}")
    print(f"[mesh] example 12 ({n} shards of 4 worlds on cuda:0) in {time.perf_counter() - t0:.2f}"
          f" s: K2 {c12['megastep']} ({n} x (1 + 50) K = 1)")
    return counts


def phase_basic_examples(golden_path) -> dict:
    """Phase 63: examples 01, 02 and 03 in torch at their own sizes on the
    card (``demo/build_a_fly``, ``replay_recorded_walking``,
    ``batched_simulation``): each one's K2 launches and output; 01's MJCF
    equal to the JAX example's (``golden_path``, scripts/
    export_examples_golden.py) and its legs in contact as the JAX example's.
    Returns each example's counts."""
    import numpy as np
    import torch

    from flygym_tpu_torch.demo import batched_simulation, build_a_fly, replay_recorded_walking

    with np.load(golden_path, allow_pickle=False) as g:
        mjcf, found = str(g["ex01.mjcf"]), g["ex01.found"]
    out = {}
    runs = (
        ("example 01", lambda: build_a_fly.main(out=Path("outputs/01_fly_world.xml"))),
        ("example 02", lambda: replay_recorded_walking.main(
            out=Path("outputs/02_replay_final_frame.mp4"))),
        ("example 03", lambda: batched_simulation.main(out=Path("outputs/03_batch_montage.png"))),
    )
    for label, run in runs:
        reset_counts()
        t0 = time.perf_counter()
        r = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = out[label] = read_counts()
        sim = r["sim"]
        check(sim.megastep and counts["tree_ldl_factor"] == 0, f"{label}: counts {counts}")
        check(bool(torch.isfinite(sim.state.qpos).all()), f"{label}: state not finite")
        if label == "example 01":
            want = int(0.05 / sim.timestep)
            check(r["path"].read_text() == mjcf, "example 01: the MJCF parts from JAX's")
            check(np.array_equal(r["found"], found), f"example 01: legs in contact {r['found']}")
            what = f"{want} K = 1 launches, MJCF equal to JAX's, legs in contact {r['found']}"
        elif label == "example 02":
            n = r["n_steps"]
            want = SETTLE_STEPS + (n // MEGASTEP_K if n % MEGASTEP_K == 0 else n)
            check(r["frame"] is not None and int(r["frame"].max()) > 0, "example 02: the frame")
            what = (f"{n} replay steps, moved {np.round(r['start'], 3)} -> "
                    f"{np.round(r['end'], 3)} mm, a mesh-fidelity frame")
        else:
            want = SETTLE_STEPS + 2 * (N_STEPS // MEGASTEP_K)
            check(r["montage"].std() > 0, "example 03: the montage")
            what = f"{r['steps_per_s']:.0f} world-steps/s at 512 worlds, montage {r['path']}"
        check(counts["megastep"] == want, f"{label}: K2 {counts['megastep']} != {want}")
        print(f"[examples] {label} in {wall:.2f} s: K2 {counts['megastep']}; {what}")
    print(f"[examples] on {card_line()}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    print(card_line())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    # Spawned workers: they import torch afresh and never touch the card.
    ops_pool = ProcessPoolExecutor(max_workers=3, mp_context=multiprocessing.get_context("spawn"))
    try:
        import flygym_tpu_torch
        from flygym_tpu_torch.compose.bridge import (
            ASSETS, BENCHMARK_FLY, BENCHMARK_GOLDEN, CPG_FLY, ENV_FLY, MIXED_FLY, MIXED_GOLDEN, MUSCLE_FLY,
            MUSCLE_GOLDEN, STRICT_FLY, STRICT_GOLDEN, TAXIS_FLY, TERRAIN_FLY, TETHERED_FLY,
            TETHERED_GOLDEN, THREEFLY, THREEFLY_GOLDEN, TWOFLY, TWOFLY_CONDIM6,
            TWOFLY_CONDIM6_GOLDEN, TWOFLY_FULL, TWOFLY_FULL_GOLDEN, TWOFLY_TERRAIN, read_meta)
        from flygym_tpu_torch.env import VectorFlyEnv
        from flygym_tpu_torch.olfaction import OdorField
        from flygym_tpu_torch.ops.megastep import megastep_supported

        compiled = flygym_tpu_torch.load_compiled()
        env_compiled = flygym_tpu_torch.load_compiled(ENV_FLY)
        terrain_compiled = flygym_tpu_torch.load_compiled(TERRAIN_FLY)
        twofly_compiled = flygym_tpu_torch.load_compiled(TWOFLY)
        full_compiled = flygym_tpu_torch.load_compiled(TWOFLY_FULL)
        pile_compiled = flygym_tpu_torch.load_compiled(THREEFLY)
        strict_compiled = flygym_tpu_torch.load_compiled(STRICT_FLY)
        muscle_compiled = flygym_tpu_torch.load_compiled(MUSCLE_FLY)
        mixed_compiled = flygym_tpu_torch.load_compiled(MIXED_FLY)
        tethered_compiled = flygym_tpu_torch.load_compiled(TETHERED_FLY)
        condim_flies = {c: flygym_tpu_torch.load_compiled(ASSETS / f"condim{c}_fly.npz")
                        for c in CONDIMS}
        taxis_compiled = flygym_tpu_torch.load_compiled(TAXIS_FLY)
        cpg_compiled = flygym_tpu_torch.load_compiled(CPG_FLY)
        weld_compiled = flygym_tpu_torch.load_compiled(ASSETS / "softweld_fly.npz")
        pgs_compiled = flygym_tpu_torch.load_compiled(ASSETS / "pgs_fly.npz")
        terrain_condim = terrain_at_condim(CONDIM_TIMED)
        composed = compose_all()
        env_world = compose("env_fly")[1]  # phase 53's world, for phase 1's build
        default_world = compose_default_env()
        condim6_pairs = flygym_tpu_torch.load_compiled(TWOFLY_CONDIM6)
        terrain_pairs = flygym_tpu_torch.load_compiled(TWOFLY_TERRAIN)
        pair_worlds = {1: compose_two_flies(1).compiled, 4: compose_two_flies(4).compiled,
                       6: condim6_pairs}
        count_ops_in_background(ops_pool, [
            ("compose:benchmark", 0), (BENCHMARK_FLY, 0), (TERRAIN_FLY, 0), (TWOFLY, 0), (TWOFLY_FULL, 0), (THREEFLY, 0),
            (STRICT_FLY, 0), (MUSCLE_FLY, 0), (MIXED_FLY, 0), (TETHERED_FLY, 0),
            (ASSETS / f"condim{CONDIM_TIMED}_fly.npz", 0), (TAXIS_FLY, 0),
            (TERRAIN_FLY, CONDIM_TIMED)])
        phase_build({"benchmark fly": compiled, "env fly": env_compiled,
                     "terrain fly": terrain_compiled, "two flies": twofly_compiled,
                     "two flies, 55 x 55 compressed": full_compiled,
                     "3-fly pile, compressed": pile_compiled,
                     "strict fly, exact Newton": strict_compiled,
                     "muscle fly": muscle_compiled, "mixed-kind fly": mixed_compiled,
                     "tethered fly": tethered_compiled,
                     **{f"condim-{c} fly": condim_flies[c] for c in CONDIMS},
                     f"terrain fly, condim {CONDIM_TIMED}": terrain_condim,
                     "taxis fly": taxis_compiled, "cpg fly": cpg_compiled,
                     # make_model's world: the sweep's and phase 43's too.
                     "composed benchmark": composed["benchmark"][1].compiled,
                     **{f"composed {name}": w.compiled for name, (_f, w) in composed.items()
                        if name != "benchmark" and megastep_supported(w.compiled.model)},
                     "composed env fly": env_world.compiled,
                     "default env fly": default_world.compiled,
                     **{f"two flies, condim {c}{'' if c == 6 else ' (composed)'}":
                        pair_worlds[c] for c in PAIR_CONDIMS},
                     "two flies on the blocks terrain, compressed": terrain_pairs,
                     "example 11 composed": compose_two_flies(3).compiled,
                     **example_worlds()},
                    compiled.model)
        lap("phase 1 (build)")
        # Phases 57-60's worlds, counted after the builds, which need the cores.
        count_ops_in_background(ops_pool, [
            (TWOFLY_CONDIM6, 0), (TWOFLY_TERRAIN, 0), ("compose:all_possible", 0),
            ("compose:two_flies_c1", 0), ("compose:two_flies_c4", 0)])
        model = compiled.model.to("cuda")
        kernels = phase_kernels(model, {"two flies, 55 x 55 compressed": full_compiled.model.to("cuda"),
                                        "3-fly pile": pile_compiled.model.to("cuda")})
        k2 = phase_megastep(compiled, model)
        # The replay protocol: settle, an untimed replay, a timed replay.
        mega_counts, mega_wall, mega_sim = phase_slice(
            compiled, label="megastep", megastep=None, settle=SETTLE_STEPS, steps=N_STEPS,
            want={"megastep": SETTLE_STEPS + 2 * (N_STEPS // MEGASTEP_K),
                  "tree_ldl_factor": 0, "tree_ldl_solve": 0}, return_sim=True,
        )
        mega_end = mega_sim.state  # phase 62 holds the sharded replay to it
        del mega_sim
        busy = (N_STEPS // MEGASTEP_K) * k2["times"][MEGASTEP_K][0] / (mega_wall * 1e3)
        print(f"[megastep] device busy share of the replay: {busy:.3f} "
              f"({N_STEPS // MEGASTEP_K} launches x {k2['times'][MEGASTEP_K][0]:.3f} ms "
              f"over {mega_wall:.3f} s)")
        engine_counts, _wall = phase_slice(
            compiled, label="engine", megastep=False, settle=ENGINE_SETTLE_STEPS,
            steps=ENGINE_STEPS,
            want={"megastep": 0, "tree_ldl_factor": ENGINE_SETTLE_STEPS + 2 * ENGINE_STEPS,
                  "tree_ldl_solve": 2 * (ENGINE_SETTLE_STEPS + 2 * ENGINE_STEPS)},
        )
        phase_golden(compiled, label="golden engine", golden_path=BENCHMARK_GOLDEN,
                     megastep=False)
        phase_golden(compiled, label="golden megastep",
                     golden_path=ASSETS / "benchmark_fly_megastep_golden.npz", megastep=True)
        lap("phases 2-6 (K1, K1b, K2, the replay)")
        retina = phase_retina(env_compiled, env_compiled.model.to("cuda"))
        env_counts, _env_wall = phase_env(VectorFlyEnv(
            env_compiled, enable_vision=True, odor_field=OdorField.for_compiled(env_compiled)))
        phase_env_golden(env_compiled, label="env golden megastep", megastep=None)
        phase_env_golden(env_compiled, label="env golden engine", megastep=False)
        lap("phases 7-9 (K3, config 5)")
        k2_terrain = phase_terrain_kernel(terrain_compiled, terrain_compiled.model.to("cuda"))
        terrain_counts = phase_terrain(terrain_compiled)
        phase_terrain_golden(terrain_compiled, label="terrain golden megastep", megastep=None)
        phase_terrain_golden(terrain_compiled, label="terrain golden engine", megastep=False)
        lap("phases 10-12 (config 3)")
        k2_pairs = phase_pairs_kernel(twofly_compiled.model.to("cuda"))
        twofly_counts, _wall = phase_twofly(twofly_compiled)
        phase_twofly_golden(twofly_compiled, label="twofly golden megastep", megastep=None)
        phase_twofly_golden(twofly_compiled, label="twofly golden engine", megastep=False)
        lap("phases 13-15 (example 11)")
        k2_comp = phase_compressed_kernel(full_compiled.model.to("cuda"),
                                          pile_compiled.model.to("cuda"))
        lap("phase 16 (K2 compressed)")
        # The rest check, or the JAX engine's own smallest settled gap if
        # that is smaller (scripts/export_compressed_golden.py).
        rest = min(REST_GAP_MM, read_meta(TWOFLY_FULL_GOLDEN)["settled_gap_min"])
        full_counts, full_wall = phase_twofly(
            full_compiled, label="twofly full", what="the default two-fly preset", rest_mm=rest,
            slide_off_mm=SLIDE_OFF_MM)
        k8 = k2_comp["times"][MEGASTEP_K][0]
        print(f"[twofly full] device busy share: "
              f"{100 * full_counts['megastep'] * k8 / (full_wall * 1e3):.1f}% "
              f"({full_counts['megastep']} launches x {k8:.3f} ms over {full_wall:.3f} s)")
        lap("phase 17 (the default two-fly preset)")
        for name, compiled_, path in (("twofly full", full_compiled, TWOFLY_FULL_GOLDEN),
                                      ("threefly", pile_compiled, THREEFLY_GOLDEN)):
            phase_twofly_golden(compiled_, label=f"{name} golden megastep", megastep=None,
                                golden_path=path)
            phase_twofly_golden(compiled_, label=f"{name} golden engine", megastep=False,
                                golden_path=path)
        lap("phase 18 (the compressed goldens)")
        k2_strict = phase_strict_kernel(strict_compiled.model.to("cuda"))
        lap("phase 19 (K2 exact Newton)")
        strict_counts, strict_wall = phase_slice(
            strict_compiled, label="strict", megastep=None, settle=SETTLE_STEPS,
            steps=CUT_REPLAY_STEPS,
            want={"megastep": SETTLE_STEPS + 2 * (CUT_REPLAY_STEPS // MEGASTEP_K),
                  "tree_ldl_factor": 0, "tree_ldl_solve": 0})
        k8 = k2_strict["times"][MEGASTEP_K][0]
        print(f"[strict] device busy share of the replay: "
              f"{(CUT_REPLAY_STEPS // MEGASTEP_K) * k8 / (strict_wall * 1e3):.3f} "
              f"({CUT_REPLAY_STEPS // MEGASTEP_K} launches x {k8:.3f} ms over "
              f"{strict_wall:.3f} s)")
        n_engine = STRICT_ENGINE_SETTLE_STEPS + 2 * STRICT_ENGINE_STEPS
        phase_slice(
            strict_compiled, label="strict engine", megastep=False,
            settle=STRICT_ENGINE_SETTLE_STEPS, steps=STRICT_ENGINE_STEPS,
            want={"megastep": 0, "tree_ldl_factor": STRICT_ITERATIONS * n_engine,
                  "tree_ldl_solve": STRICT_ITERATIONS * n_engine})
        print(f"[strict engine] K1 and K1b launches per step: {STRICT_ITERATIONS} each")
        lap("phase 20 (the strict replay)")
        k2_act = phase_actuator_kernels(muscle_compiled.model.to("cuda"),
                                        mixed_compiled.model.to("cuda"))
        lap("phase 21 (K2 actuator kinds)")
        muscle_counts, muscle_wall = phase_muscle(muscle_compiled)
        k8 = k2_act["muscle kernel"]["times"][MEGASTEP_K][0]
        print(f"[muscle] device busy share: "
              f"{muscle_counts['megastep'] * k8 / (muscle_wall * 1e3):.3f} "
              f"({muscle_counts['megastep']} launches x {k8:.3f} ms over {muscle_wall:.3f} s)")
        mixed_counts = phase_mixed(mixed_compiled)
        lap("phase 22 (the muscle-driven and mixed-kind flies)")
        for label, compiled_, path in (("strict", strict_compiled, STRICT_GOLDEN),
                                       ("muscle", muscle_compiled, MUSCLE_GOLDEN),
                                       ("mixed", mixed_compiled, MIXED_GOLDEN)):
            phase_actuator_golden(compiled_, path, label=label)
        lap("phase 23 (the actuator and strict goldens)")
        k2_teth = phase_tethered_kernel(tethered_compiled.model.to("cuda"))
        teth_counts, teth_wall, _sim = phase_actuated_rollout(
            tethered_compiled, label="tethered", n_steps=TETHERED_STEPS, ctrl_fn=tethered_torques)
        k8 = k2_teth["times"][MEGASTEP_K][0]
        print(f"[tethered] device busy share: "
              f"{teth_counts['megastep'] * k8 / (teth_wall * 1e3):.3f} "
              f"({teth_counts['megastep']} launches x {k8:.3f} ms over {teth_wall:.3f} s)")
        phase_replay_golden(tethered_compiled, TETHERED_GOLDEN, label="tethered")
        lap("phases 24-26 (the tethered fly, K2 without contact candidates)")
        phase_single_world(compiled, tethered_compiled)
        lap("phase 27 (the single-world API)")
        phase_sweep()
        lap("phase 28 (the world sweep and the benchmark entry)")
        phase_trace(compiled)
        lap("phase 29 (the profiler trace)")
        k2_condim = phase_condim_kernels(condim_flies, terrain_condim)
        lap("phase 30 (K2 at condim 1, 4 and 6)")
        condim_counts, condim_wall = phase_slice(
            condim_flies[CONDIM_TIMED], label=f"condim{CONDIM_TIMED}", megastep=None,
            settle=SETTLE_STEPS, steps=CUT_REPLAY_STEPS,
            want={"megastep": SETTLE_STEPS + 2 * (CUT_REPLAY_STEPS // MEGASTEP_K),
                  "tree_ldl_factor": 0, "tree_ldl_solve": 0})
        k8 = k2_condim[CONDIM_TIMED]["times"][MEGASTEP_K][0]
        print(f"[condim{CONDIM_TIMED}] device busy share of the replay: "
              f"{(CUT_REPLAY_STEPS // MEGASTEP_K) * k8 / (condim_wall * 1e3):.3f} "
              f"({CUT_REPLAY_STEPS // MEGASTEP_K} launches x {k8:.3f} ms over "
              f"{condim_wall:.3f} s)")
        lap(f"phase 31 (the condim-{CONDIM_TIMED} replay)")
        for c in CONDIMS:
            phase_replay_golden(condim_flies[c], ASSETS / f"condim{c}_fly_golden.npz",
                                label=f"condim{c}")
        lap("phase 32 (the condim goldens)")
        k2_taxis = phase_taxis_kernel(taxis_compiled)
        lap("phase 33 (K2 at K = 20 for config 4)")
        taxis = phase_taxis(taxis_compiled, N_WORLDS, "taxis")
        lap("phase 34 (config 4 at 4096 worlds)")
        phase_taxis(taxis_compiled, 1, "taxis B=1")
        lap("phase 35 (config 4, one fly)")
        phase_taxis_golden(taxis_compiled)
        lap("phase 36 (the taxis goldens)")
        phase_cpg_walking(cpg_compiled)
        lap("phase 37 (config 2)")
        phase_cpg_golden(cpg_compiled)
        lap("phase 38 (the CPG walking goldens)")
        phase_solvers(weld_compiled, pgs_compiled)
        lap("phase 39 (soft welds and PGS)")
        phase_render_golden()
        lap("phase 40 (the render golden's cases)")
        phase_render_frames()
        lap("phase 41 (frames at full size)")
        phase_render_hooks(compiled)
        lap("phase 42 (the render hooks)")
        phase_render_benchmark()
        lap("phase 43 (run_benchmark with rendering)")
        phase_render_vision(env_compiled, terrain_compiled)
        lap("phase 44 (FlyEnv's frame and the heightfield retina)")
        k2_composed, composed_counts, bench_sim = phase_composed_benchmark(
            composed["benchmark"][1])
        lap("phase 45 (the benchmark world composed by the port)")
        option_counts = phase_composed_options(composed, bench_sim)
        del bench_sim
        lap("phase 46 (trim_contacts and simplify_geom)")
        biological_counts = phase_all_biological(*composed["all_biological"])
        phase_composed_against_files(composed)
        lap("phase 47 (every biological joint; the composed tethered and terrain worlds)")
        phase_mjcf(composed["benchmark"][1])
        lap("phase 48 (the MJCF)")
        grad_kernels = phase_grad_kernels(model, env_compiled)
        lap("phase 49 (K1 and K1b under autograd)")
        grad_counts = phase_grad_step(compiled)
        lap("phase 50 (gradients through the step, example 10)")
        phase_pose_conversion()
        lap("phase 51 (the pose conversion)")
        phase_powf(model)
        lap("phase 52 (K2's pow of subnormal x)")
        composed_env_counts, _wall = phase_composed_env(env_compiled)
        lap("phase 53 (config 5 on the env that composes its world)")
        example_counts = phase_rl_examples()
        lap("phase 54 (examples 06 and 09)")
        es_full = phase_es("example 13", ES_FULL, learn=False)
        lap("phase 55 (example 13 at its own width)")
        es_small = phase_es("example 13 --small", ES_SMALL, learn=True)
        lap("phase 56 (example 13 at --small)")
        k2_condims = phase_pair_condims(pair_worlds)
        k2_pairs6 = k2_condims[6]
        lap("phase 57 (K2 with pair rows at condim 1, 4 and 6)")
        pairs6_counts, pairs6_wall = phase_twofly(
            condim6_pairs, label="twofly condim6", what="example 11 at condim 6",
            engine_steps=PAIR_ENGINE_STEPS)
        k8 = k2_pairs6["times"][MEGASTEP_K][0]
        print(f"[twofly condim6] device busy share: "
              f"{100 * pairs6_counts['megastep'] * k8 / (pairs6_wall * 1e3):.1f}% "
              f"({pairs6_counts['megastep']} launches x {k8:.3f} ms over {pairs6_wall:.3f} s)")
        for megastep_ in (None, False):
            phase_twofly_golden(
                condim6_pairs, golden_path=TWOFLY_CONDIM6_GOLDEN, megastep=megastep_,
                label=f"twofly condim6 golden {'engine' if megastep_ is False else 'megastep'}")
        lap("phase 58 (example 11 at condim 6)")
        k2_pairs_terrain, pairs_terrain_counts = phase_pair_terrain(terrain_pairs)
        lap("phase 59 (example 11 on the blocks terrain, compressed pair rows)")
        k2_all_possible, all_possible_counts = phase_all_possible(
            composed["all_possible"][1].compiled)
        lap("phase 60 (ALL_POSSIBLE)")
        example_11_counts = phase_two_flies_example(condim6_pairs)
        lap("phase 61 (example 11 in torch)")
        phase_mesh(compiled, mega_end, mega_wall, terrain_compiled, full_compiled)
        lap("phase 62 (worlds split over 2 shards of cuda:0, example 12)")
        phase_basic_examples(ASSETS / "examples_basic_golden.npz")
        lap("phase 63 (examples 01, 02 and 03)")
        print(f"[rl] K2 launches on {card_line()}: config 5 composed "
              f"{composed_env_counts['megastep']}, example 06 {example_counts['example 06']['megastep']}"
              f", example 09 {example_counts['example 09']['megastep']}, example 13 "
              f"{es_full['counts']['megastep']} (--small {es_small['counts']['megastep']}); "
              f"tree-LDL 0 on each")
        print(f"[composed] K2 launches on {card_line()}: benchmark {composed_counts['megastep']}, "
              + ", ".join(f"{k} {v['megastep']}" for k, v in option_counts.items())
              + f", all biological {biological_counts['megastep']}")
    except (PhaseFailed, ImportError, RuntimeError, ValueError, TypeError,
            NotImplementedError) as e:
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    finally:
        ops_pool.shutdown(cancel_futures=True)

    entries = [
        {
            "name": name,
            "route": "cuda",
            "source": "flygym_tpu_torch/csrc/tree_ldl.cu",
            "replaces": replaces,
            "launches": engine_counts[name],
            "max_abs_err": kernels["err"][name],
            "ms": kernels["times"][name][0],
            "plain_ms": kernels["times"][name][1],
            "bound_ms": kernels["bounds"]["need"][name][0],
            "bound_by": kernels["bounds"]["need"][name][1],
            "library_ms": kernels["library"][name],
            # K1/K1b before their redesign (its wrapper call, as "ms" is the
            # shipped wrapper's), the shipped launch alone, the bound with L
            # written over its chain entries only, and the one with all of H
            # read (bound_ms reads H's envelope and writes L with its padding).
            "before_ms": kernels["before_ms"][name],
            "launch_ms": kernels["launch_ms"][name],
            "bound_envelope_ms": kernels["bounds"]["envelope"][name][0],
            "bound_dense_ms": kernels["bounds"]["dense"][name][0],
        }
        for name, replaces in (
            ("tree_ldl_factor", "flygym_tpu/ops/ldl_pallas.py:54"),
            ("tree_ldl_solve", "flygym_tpu/ops/ldl_pallas.py:72"),
        )
    ]
    # K1b run again on the same factor as the backward of the solve under
    # autograd: its launches on example 10's path (phase 50), its time the
    # backward's (one K1b launch and gH) at N_WORLDS, against the same
    # backward through the plain factor and solve (phase 49).
    entries.append({
        "name": "tree_ldl_solve_backward",
        "route": "cuda",
        "source": "flygym_tpu_torch/csrc/tree_ldl.cu",
        "replaces": "flygym_tpu/ops/ldl_pallas.py:72",
        "launches": grad_counts["tree_ldl_solve_backward"],
        "max_abs_err": grad_kernels["err"],
        "ms": grad_kernels["ms"],
        "plain_ms": grad_kernels["plain_ms"],
        "bound_ms": grad_kernels["bound"][0],
        "bound_by": grad_kernels["bound"][1],
        "library_ms": None,
        "forward_ms": grad_kernels["forward_ms"],
        "forward_backward_ms": grad_kernels["forward_backward_ms"],
    })
    entries.append(k2_entry("megastep", k2, mega_counts["megastep"], MEGASTEP_K))
    entries.append({
        "name": "retina",
        "route": "cuda",
        "source": "flygym_tpu_torch/csrc/retina.cu",
        "replaces": "flygym_tpu/ops/retina_pallas.py:133",
        "launches": env_counts["retina"],
        "max_abs_err": retina["err"],
        "ms": retina["times"][0],
        "plain_ms": retina["times"][1],
        "bound_ms": retina["bound"][0],
        "bound_by": retina["bound"][1],
        "library_ms": None,
        # Every (ray, geom) pair swept, K3 before its redesign, and the
        # share of (tile, geom) pairs the cull kept (profile build).
        "bound_all_pairs_ms": retina["bound_all_pairs"][0],
        "before_ms": retina["before_ms"],
        "kept_share": retina["kept_share"],
    })
    # K2 built for the terrain fly: its K = 1 launch, as config 3's closed
    # loop makes it (1000 of its 1063 launches); for example 11's two flies
    # its K = 8 launch, as the 800-step rollout makes it (100 launches).
    entries.append(k2_entry("megastep_terrain", k2_terrain, terrain_counts["megastep"], 1))
    entries.append(k2_entry("megastep_pairs", k2_pairs, twofly_counts["megastep"], MEGASTEP_K))
    # For the default two-fly preset's compressed rows, its K = 8 launch, as
    # its 800-step rollout makes it (100 launches).
    entries.append(k2_entry("megastep_pairs_compressed", k2_comp, full_counts["megastep"],
                            MEGASTEP_K))
    # The exact Newton's K = 8 launch, as the strict replay makes 100 of its
    # 600; every actuator kind's, as the muscle-driven and mixed-kind
    # rollouts make them.
    entries.append(k2_entry("megastep_strict", k2_strict, strict_counts["megastep"], MEGASTEP_K))
    entries.append(k2_entry("megastep_muscle", k2_act["muscle kernel"], muscle_counts["megastep"],
                            MEGASTEP_K))
    entries.append(k2_entry("megastep_mixed", k2_act["mixed kernel"], mixed_counts["megastep"],
                            MEGASTEP_K))
    # Without contact candidates: the tethered rollout's K = 8 launch.
    entries.append(k2_entry("megastep_tethered", k2_teth, teth_counts["megastep"], MEGASTEP_K))
    # Slice g.3: the condim-6 replay's K = 8 launch (100 of its 600), and
    # config 4's K = 20 launch, each of its settle and one per control step.
    entries.append(k2_entry(f"megastep_condim{CONDIM_TIMED}", k2_condim[CONDIM_TIMED],
                            condim_counts["megastep"], MEGASTEP_K))
    k_taxis, = k2_taxis["times"]
    entries.append(k2_entry("megastep_taxis", k2_taxis, taxis["counts"]["megastep"], k_taxis))
    # The benchmark world the port composed: its replay's K = 8 launch.
    entries.append(k2_entry("megastep_composed", k2_composed, composed_counts["megastep"],
                            MEGASTEP_K))
    # Slices g.3 on pair rows, g.2 and g.5: each header's checked launch at
    # PAIR_CHECK_WORLDS (K = 8 at condim 6 and on the terrain, else K = 1)
    # beside its plain version there; launches of the
    # 800-step rollouts (100 K = 8: condim 1 and 4 those of example 11 in
    # torch at B = 1) and of ALL_POSSIBLE's 400 (50 K = 8).
    for c in (1, 4):
        entries.append(k2_entry_at(f"megastep_pairs_condim{c}", k2_condims[c],
                                   example_11_counts[f"B=1, condim {c}"]["megastep"]))
    entries.append(k2_entry_at("megastep_pairs_condim6", k2_pairs6, pairs6_counts["megastep"]))
    entries.append(k2_entry_at("megastep_pairs_terrain", k2_pairs_terrain,
                               pairs_terrain_counts["megastep"]))
    entries.append(k2_entry_at("megastep_all_possible", k2_all_possible,
                               all_possible_counts["megastep"]))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
