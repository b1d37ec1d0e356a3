#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, one line each:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: compiles the CUDA kernels in newton_tpu_torch/csrc with nvcc;
  3. B1: the Cholesky/solve/inverse kernel vs its plain PyTorch version,
     W = 4096, d in {14, 23}, elementwise (atol 1e-5, rtol 1e-4) and
     normwise against a float64 solve (at most max(2 x the plain
     version's error, 1e-5)); kernel, plain and torch.linalg.solve
     (B1's library yardstick) timed at both sizes;
  4. B2: the fused PGS kernel vs its plain version at ant shapes (c = 25,
     nl = 8, d = 14, W = 4096) on random inputs (both friction cones, and
     nl = 0) and on inputs captured from a real ant substep with the root
     pushed 0.08 into the ground; envs whose divergence-guard halvings
     differ are counted and reported, never hidden in a tolerance;
  5. main path: gymnasium ant (newton_tpu_torch/assets/ant.xml) at 4096
     envs, a warm-up frame then 10 frames x 4 substeps (dt = 1/240,
     8 PGS iterations, euler, uniform random MJCF ctrl), asserting exactly
     one launch of each kernel per substep, no NaN, unit quaternions and
     root z > 0.1, then timing env-steps/s on the kernel path and on the
     plain path in alternating turns;
  6. one substep through the kernels vs one through the plain versions,
     from the same cloned state and ctrl;
  7. B3/B4: the MPM P2G (C = 13) and G2P (C = 12) kernels and their plain
     float32 versions vs a float64 plain result, |err| <= 1e-5 S + 1e-7
     with S the float64 sum of magnitudes, at N = 32768, res 64, on bases
     drawn over -2..res (border clipping), on the real sand state's, all
     in one cell, 64 per cell and none (an all-zero grid), with the bins
     passed and without; the binning kernels' offsets and tile records
     equal the plain binning's; G2P equal bit for bit across calls; B3
     timed with its binning and given bins, the binning alone, B4 given
     bins, and the distinct nodes the sand stencils touch (B4's bound);
  8. MPM main path: bench.py --mode mpm's sand (32768 particles uniform in
     [-0.3, 0.3]^2 x [0.05, 0.8], mass 0.002, grid (-1, -1, 0)-(1, 1, 2) at
     res 64, friction 0.6, young 5e4, explicit, dt 4e-4), 25 warm-up steps
     then 100 checked steps with exactly one launch of each kernel and
     one binning per step, finite state, min z > -0.05, |x|, |y| < 1 and
     a falling mean z,
     then particle-steps/s on the kernel and plain paths in turns;
  9. the CG (implicit_iterations = 8) and implicit-rheology paths, 10
     steps each at the same size, with their launch counts per step
     (1 + 9 of each kernel for CG, 1 for the rheology path, one binning
     per step on both);
 10. one MPM step through the kernels, one through the plain versions and
     one plain step in float64, from the same cloned sand state: the two
     float32 paths agree with each other and with float64 to q 1e-6, qd
     1e-4, F 1e-5 and C 1e-3 max(1, max |C|);
 11. humanoid main path: gymnasium humanoid
     (newton_tpu_torch/assets/humanoid.xml: D6 hips, abdomen and
     shoulders, fixed tendons, 192 contact slots compacted to the top 32
     per env) at 4096 envs from joint_q0 with uniform +-0.01 reset noise,
     10 warm-up frames (the feet reach the floor) then 10 checked frames
     as in phase 5, asserting exactly one launch of each kernel per
     substep, no NaN, unit quaternions, root z > 0.3 and an active
     contact during the window in 99% of envs (random ctrl flings the
     legs: a few envs touch nothing in the window, ~20% at any one
     instant); then env-steps/s in turns;
 12. humanoid kernel vs plain substeps, from one cloned state and ctrl:
     (a) the main window's end, (b) a lying pose with contact_cap = 8
     (compaction drops active contacts), (c) the lying pose uncompacted
     (all 192 slots: B2's large-shared-memory launch); envs whose
     divergence-guard halvings differ are counted and left out. B1 and B2
     are held against their plain versions on the operands of those
     substeps (B1 within atol 1e-5, rtol 1e-4) and timed at the
     humanoid's shapes (d = 23, with torch.linalg.solve beside it; c, nl =
     32, 17 and 192, 17);
 13. cartpole x 8192 (the reference's KPI Cartpole): replicate(gymnasium's
     inverted pendulum, 8192) -> SolverMuJoCo(iterations=4, euler).step
     on the flat state, uniform ctrl in [-3, 3]; exactly one B1 launch
     per substep (d = 2, the 8-row register instance), the limits-only
     solve and no B2; finite state, the slider within its range + 0.05;
     env-steps/s on the kernel and plain paths in turns; one kernel vs
     plain step;
 14. humanoid x 8192 (the reference's KPI Humanoid) through replicate +
     step, run as phase 11: one launch of B1 (d = 23) and B2 (32, 17, 23)
     per substep, phase 11's gates, env-steps/s in turns, the phase's peak
     device memory, and step against step_batched of the one-world
     humanoid on the same worlds (equal to 1e-6) for 4 substeps;
 15. C.1 shapes: a 40-link chain (d = 45, W = 1024) and a 165-link chain
     (d = 170, W = 64) on a plane through step_batched, reaching B1's
     generic instances (shared memory, global scratch) and B2's
     shared-memory (32, 39, 45) and global-scratch (32, 164, 170)
     instances, each held against its plain version; B2 alone at
     (192, 40, 48) (a block state above 227 KB) on random operands;
 16. half_cheetah x 4096 (bench.py --robot half_cheetah: step_batched,
     euler, 8 PGS iterations, dt 1/240, 4 substeps, uniform ctrl in
     [-1, 1]; its root a D6 joint of rootx, rootz and rooty): a warm-up
     frame then 10 frames with one launch of B1 (d = 9, reg16) and B2
     (16, 6, 9, smem128) per substep, finite state, unit quaternions,
     torso z > 0, an active contact during the window in 99% of envs; a
     kernel vs plain substep; the same envs moved 5 m along x agree after
     4 substeps (joint_q 1e-4, joint_qd 1e-3); env-steps/s in turns;
 17. hopper x 8192 through replicate + step as gymnasium's Hopper-v5
     (SolverMuJoCo(iterations=8), integrator read from the asset: RK4; dt
     0.002, 4 substeps per frame, +-5e-3 reset noise, ctrl in [-1, 1]):
     10 warm-up and 10 checked frames with four B1 launches (d = 6, reg8,
     one per RK4 stage) and one B2 launch (14, 3, 6, smem128) per
     substep, finite state, torso z > 0; step against step_batched of the
     one-world hopper (1e-6) for 4 substeps; a kernel vs plain step;
     env-steps/s in turns and the phase's peak device memory;
 18. rod x 4096 (example_rod_swing.py's ball-jointed rod, replicated 0.1 m
     apart in y, so each world's root joint_X_p differs; SolverFeatherstone
     step at dt 1/480, 8 substeps per frame, no contacts, as the example):
     1/3 s with one B1 launch (d = 21, reg24) per substep and no B2; finite
     state, unit ball quaternions, every tip z in (0.6, 1.01], world k's
     tip world 0's moved by its offset (1e-4); step against its group
     stepped alone (1e-6); a kernel vs plain step; env-steps/s in turns,
     setup time and peak device memory;
 19. ant with a ball x 4096 (gymnasium's ant and a free 0.45 kg ball of
     radius 0.2 touching its front-left foot, two articulations per
     world), randomized per world after the solver is built (ant masses
     and inertias x U(0.8, 1.2), every mu in U(0.5, 1.25)), then
     notify_model_changed; SolverMuJoCo(iterations=8, euler) through step,
     dt 1/240, 4 substeps per frame, uniform ctrl: a warm-up frame then 10
     frames with one B1 and one B2 launch per group per substep (ant d =
     14, B2 (32, 8, 14) reg16; ball d = 6, B2 (14, 0, 6) smem128; both B2
     calls with w_other, the two-sided contacts' diagonal addend); phase
     5's gates, an ant-ball contact in >= 50% of worlds during the window,
     ball speed < 20 m/s; the two halves of each active ant-ball contact
     finite and >= 0 (their mismatch reported); step against its groups
     stepped alone (1e-6); a kernel vs plain step; env-steps/s in turns,
     setup time and peak device memory;
 20. not user configurations, 1024 worlds each: the joint showcase
     (example_basic_joints.py, each joint its own articulation: six
     groups, one without dofs) for 0.5 s, one B1 launch per group with
     dofs per substep, the example's gates in every world; and the ragged
     plan (example_hetero_worlds.py with a static sphere pedestal in the
     odd worlds), 1.25 s with one B1 and one B2 (2, 0, 6) per substep,
     spheres at rest at z = 0.3 and 0.7 (+-0.05); each with a kernel vs
     plain step and step against its groups alone;
 21. ant x 4096 under SolverXPBD (bench.py --solver xpbd: replicate, the
     static pipeline, iterations 8, dt 1/240, 4 substeps, direct ctrl x
     mjc:actuator_gear each frame from a seeded generator): 10 warm-up
     and 10 timed frames (bench.py times 50), no NaN, unit quaternions,
     root z > 0 in every world and > 0.1 in 99% (the JAX package's XPBD
     ant sinks below 0.1 too, ROADMAP C.13), no B1/B2 launch (no TPU
     kernel lies on the XPBD path); 8 worlds stepped 4 substeps on the
     card equal the port on the CPU (body_q 2e-4, joint_qd 5e-3; at most
     one world whose contact set differs between the two left out); two
     runs of one substep on the card equal bit for bit; one profiled
     frame; env-steps/s, setup seconds, peak device
     memory;
 22. pyramid x 1024 (example_pyramid.py: six free boxes in rows 3-2-1,
     mu 0.8) on SolverFeatherstone(contact_iterations=16), dt 1/240, 4
     substeps, 40 frames: one group of d = 36 whose 288 box entries per
     world are compacted to 32, one B1 (generic_smem) and one B2 ((32, 0,
     36), smem128) launch per substep; the example's gates in every world
     (top box z > 0.6, |x|, |y| < 0.1; every box |x|, |y| < 0.8); a kernel
     vs plain step (phase 6's tolerances and guard-mismatch count); one
     substep with contact_cap=0 (B2 (288, 0, 36) global256) held
     likewise; env-steps/s in turns;
 23. domino spiral x 1024 (example_domino_spiral.py, the first domino
     nudged) under SolverXPBD(iterations=4), dt 1/240, 4 substeps, 110
     frames replayed from a CUDA graph of the substep: the first five
     dominoes tipped (up-z < 0.75) in every world, the worlds where all
     ten tipped, no B1/B2 launch; one profiled frame; env-steps/s over 2
     eager frames;
 24. the bench cloth (bench.py --mode cloth as published: a 100 x 100
     grid of cell 0.01 pinned along its top row at z = 2, mass 2, tri_ke
     500, edge_ke 1) under SolverStyle3D(iterations=4), no contacts, dt
     1/240, 4 substeps: 10 warm-up and 50 timed frames; finite, the pinned
     row within 1e-3 of z = 2, the free vertices' mean z below 2, no
     triangle edge beyond 2.5 x its rest length, the PD system's 8-step
     PCG residual below 1e-3 relative on the slow test's right-hand side;
     no B1-B4 launch (no TPU kernel lies on the cloth path); one profiled
     frame (device ops per substep, busy share, no device-to-host copy);
     one substep on the card against the CPU (particle_q 2e-4,
     particle_qd 5e-3) and two card runs of it against each other (bit
     for bit); vertex-steps/s, setup seconds, peak device memory;
 25. example_cloth_style3d.py as published (two sewn 10 x 10 panels on a
     static capsule torso over a ground plane, CollisionPipeline soft
     contacts each substep, SolverStyle3D(iterations=6, contact_ke=2e4),
     dt 1/480, 8 substeps, 50 frames): the example's test_final (finite,
     seam gap < 0.25, max z > 0.9, the last held at every frame through
     frame 40 and reported at frame 50: the garment slides off its torso
     from about frame 50 in both packages, ROADMAP C.16); a card vs CPU
     substep with contacts;
 26. SolverVBD(iterations=4): (a) example_cloth_bending.py as published,
     40 frames, its test_final; (b) the bench cloth (not a published
     configuration), 10 warm-up and 20 timed frames: finite and the
     pinned row within 1e-3 (the drape is reported, not gated: the JAX
     package's VBD over-stretches this cloth, ROADMAP C.15), profile, a
     card vs CPU substep from rest (gated) and from the run's end state
     (reported); (c) the garment lowered into the ground plane: one
     substep with active soft contacts, card vs CPU reported;
 27. SolverSemiImplicit: test_semi_implicit_stable's 6 x 6 cloth (dt
     1/2000, 20 substeps, 30 frames) and a soft block of 4^3 cells
     (example_softbody_hanging.py's material) pinned at one face for 1 s:
     finite, the pinned particles exactly in place, the block sagged by
     less than 0.6; a card vs CPU substep of each;
 28. IK at bench.py --mode ik's configuration: the 3-link revolute-Z
     chain, IKObjectivePosition(link=2, offset=(0.5, 0, 0)), 4096
     seeded targets (angle U(0, 2 pi), radius U(0.5, 2.4)), 4 GAUSS
     seeds, 16 LM iterations: finite q, tip error < 0.02 in >= 99% of
     problems, at most one host sync per solve; 64 problems on the card
     against the CPU (residual 1e-5, Jacobian 1e-4 relative, q after one
     LM step from each seed off the straight start 1e-4, both meet the
     tip gate after 16 iterations; the whole solves' q reported);
     solves/s over 5 solves, peak device memory;
 29. warm start and sleeping x 4096: the ant under
     test_sleep_and_warm_start's settings (60 frames, root z in (0.3,
     0.8) in every world), example_mujoco_sleeping.py's boxes with
     warm_start=True (its test_final in every world, the asleep worlds'
     body_q bit-frozen over a further frame) and the humanoid with
     warm_start=True through top-32 compaction (phase 11's gates); for
     each B2 with its warm lam0 held against the plain version, the
     guard halvings warm and cold, env-steps/s warm and cold in turns;
 30. equality rows x 4096 (60 frames, no contacts): the CONNECT linkage,
     the mimic pair and a WELD, each with tests/test_equality.py's gates
     in every world, per substep one B1 launch on M + dt Kd and one of
     B1 without the inverse (chol_solve) on the equality system, r = 3,
     1, 6, each held against the plain version;
 31. URDF x 4096: example_basic_urdf.py's double pendulum through
     add_urdf (15 frames of 8 substeps at dt 1/480, its test_final in
     every world) and the same robot with a <mimic> elbow (|q_elbow +
     q_shoulder| < 2e-2).
 32. the Newton QP (the ant x 4096, solver="newton": one B1 and no B2 per
     substep, no host sync beyond the Euler PGS substep's, the masked
     solve timed), tests/test_parity_mujoco.py's resting ball x 4096 (0.5
     s at dt 0.002, force within 1% of the weight, z within 2e-3) and
     the ant under penalty limits without body forces (B2 at (25, 0,
     14));
 33. the humanoid x 4096 under implicitfast (one B1 and B2 per substep,
     equal to Euler within 1e-6: D = 0) and implicit (LU, no B1; B2 in
     its non-symmetric form, held against its twin within 1e-5);
 34. example_tendon_finger.py's finger x 4096 (spatial tendon over wrap
     cylinders), 3 s under euler and implicitfast: the pip flexes past
     0.3 rad, |q| < 1 after 2.5 s;
 35. the test arm (newton_tpu_torch/assets/muscle_arm.xml: muscles on
     spatial tendons, filter, cylinder, intvelocity and damper actuators)
     x 4096 under euler and implicitfast: activations in [0, 1], the
     flexor flexes the elbow; SolverSemiImplicit's muscle pair x 4096;
 36. SolverKamino: the heavy stack x 1024 (60 frames, error < 0.03,
     PGS's > 2x), the kicked four-bar x 4096 (60 frames, drift < 2e-2) and
     build_stacks(3, 2) x 1024 (islands equal the dense factor within
     5e-5 / 5e-4 over 30 steps).
 37. example_basic_conveyor_forces.py x 4096: a kinematic belt (a body
     without a joint at 0.6 m/s) under two crates on free joints, mu 0.9,
     SolverMuJoCo(iterations=16, warm_start=False) with step_with_contacts
     every substep: B1 at d = 12 and B2 (32, 0, 12) with the belt as the
     moving support (w_other 0, constant rows); each crate at the belt's
     speed within 5%, each world's normal force within 10% of both
     crates' weight, the drag finite;
 38. a two-link arm mounted on a free box base x 4096 (two groups, the
     arm carrying the base as its mount): the reference defect C.24 (the
     base falls at g (m_base + m_arm) / m_base) held as pinned;
 39. tests/test_stacking.py's third-law tower x 4096 (contact_cap=0):
     the ground carries both weights, the box-box contact one, within 35%;
 40. the bench cloth under SolverXPBD(iterations=4, no particle-particle
     contacts) beside Style3D's vertex-steps/s, and a 20 x 20 grid four
     substeps card vs CPU;
 41. tests/test_cloth_solvers.py's two layers widened to 70 x 70 cells
     each (10,082 particles), particle-particle contacts through the hash
     grid: separated by more than 0.025; 42. a granular pile of 32,768
     particles (radius 0.05) on the ground: above z = 0.03 and no two
     closer than 0.085; the hash grid's dropped candidates counted;
 43. example_cable_pile.py x 1024 in the example's pipeline mode
     (dynamic-pair, ``mode="auto"``; static and dynamic slot counts, the
     overflow count, the start state's active pairs equal to static
     mode's) and tests/test_cable.py's cantilevers x 1024 (the stiffer
     sags less); 44. example_cable_dahl_hysteresis.py x 1024 and the Dahl
     presliding hold of tests/test_dahl_friction.py:63 x 1024. Phases
     40-47 launch no B1-B4 kernel.
 45. example_basic_shapes.py x 4096 (the cone and ellipsoid pairs through
     one batch of support-map MPR): the example's rest heights in every
     world; tests/test_geometry.py:441's cone on a box x 4096: cone z =
     0.75 +- 0.06; operations of a collide and the support batch's share;
 46. example_box_pile.py x 1024 in dynamic-pair mode (budget 8 x 96 x W):
     the example's gates, broad_phase_dropped per frame; 47. the same pile
     with broad_phase="sap": its active shape pairs equal top-k's in every
     world at the start, after 8 frames and compressed (ROADMAP C.26 not
     copied), both broad phases timed;
 48. example_peg_insertion.py x 4096 (SolverMuJoCo, one B1 d = 6 and one
     B2 (72, 0, 6) per substep) and example_kamino_mass_ratio.py x 1024
     (SolverKamino, one B1 d = 12) on persistent manifolds: the examples'
     gates (the peg in 99% of worlds), B1 and B2 against their plain
     versions, timed;
 49. the slice's main path: example_terrain_ant.py x 4096 (gymnasium's
     ant over the example's fractal heightfield, root raised 0.6)
     through replicate + SolverMuJoCo(iterations=8, euler).step with the
     static pipeline's flat Contacts (the heightfield's two-sided class
     beside the floor's slots), a warm-up frame then 40 frames with
     random ctrl: one B1 (d = 14) and one B2 (32, 8, 14) a substep, the
     example's torso gate in every world, a quarter of the worlds on the
     field, B1 and B2 against their plain versions (N / 100 B2 rows whose
     guard halvings differ counted), the card against the CPU on 64
     worlds, the SDF pool's bytes and the mesh samples dropped;
 50. x 1024 each, 1 s (the stack 0.25 s): example_mesh_stack.py
     (hydroelastic, SolverFeatherstone: B1 d = 18, B2 on the mesh-mesh
     and mesh-plane rows), example_compliant_pad.py (hydroelastic,
     SolverXPBD's compliant rows: the settled depth within 30% of
     m g / (k_eff A)),
     example_nut_bolt_sdf.py with the torus's sparse texture (res 64) and
     example_convex_stack.py (hulls through MPR, no bake): each example's
     test_final in every world;
 51. example_pile_sap.py as published (512 hulls, dynamic SAP, budget
     4096, window 24), dt 1/120 for 0.5 s: 0 dropped, z in (-0.05, 2);
     the card against the CPU per hull (1% may part on MPR ties);
 52. the slice's main path: example_vbd_rigid_rigid_contact.py x 4096
     (two boxes of half-size 0.12, mu 0.6, persistent manifolds) under
     SolverVBD(iterations=8)'s AVBD, dt 1/240, 50 frames eager: one B1
     solve (chol_solve, d = 6, W = 8192 bodies) a sweep, the example's
     test_final in every world, 16 worlds against the CPU (float64
     witness), 0 host syncs; the ball pendulum x 4096 (length within
     2e-3) and the VBD cable rod x 1024 at bend_ke 0.5 and 500;
 53. SolverCoupled: the seesaw x 256 (SolverMuJoCo with SolverXPBD, the
     consensus's residuals; B1 d = 1 and B2 twice a substep, 0 host
     syncs), the cloth on a ball x 256 (SolverVBD for the particles),
     the head-on pair x 4096 split between SolverXPBD and SolverMuJoCo,
     and the mixed tower x 256 split between SolverXPBD and SolverVBD
     (finite over 2 frames and held to the CPU: the reference's tower
     fails its gate, ROADMAP C.33); each scene's gates in every world and
     4 worlds on the card against the CPU (float64 witness);
 54. the slice's main path: an ONNX policy drives the ant x 4096 through
     the RL layer (example_robot_policy.py's workload at Ant-v5's
     width): replicate(ant with a torso site "imu", 4096) (the ground is
     each world's ant.xml floor) -> SolverMuJoCo(iterations=8, euler)
     through step_with_contacts; a frame reads a 36-wide observation
     from ArticulationView (root z and quaternion, 8 hinge angles, root
     twist, 8 hinge rates), SensorIMU (acceleration / 9.81, angular
     velocity) and SensorContact (the ground's net force on the four
     lower legs over the world's weight), runs the MLP 36-64-64-8 (Tanh,
     weights N(0, 1)/sqrt(fan_in) from numpy default_rng(0), biases 0)
     serialized by encode_mlp through OnnxModule, drives the 8 hinges
     through Actuator(ControllerPD(40, 1) to mid + half-range x action,
     ClampMaxEffort(150), delay_steps=2: one frame of lag, C.35) into
     joint_f, steps 4 substeps of dt 1/240, then resets (solver.reset,
     view.eval_fk, the mask on the device) the worlds whose torso left
     [0.2, 1.0] and, at frame 20, every 7th world; 5 warm-up then 60
     timed frames with one B1 (reg14) and one B2 launch a substep;
     finite, unit quaternions, the reset worlds bit for bit at the
     initial state and the others bit for bit as without the reset; a
     frame through the kernels against one through the plain versions
     (joint_q 2e-4, joint_qd 5e-3, actions 1e-5), B1 and B2 against
     their twins on its operands; two runs of a frame bit for bit; 0 host
     syncs a frame; env-steps/s, device ms and operations a frame, busy
     share, policy and sensor ms, worlds reset;
 55. beside it, the mesh-geom Franka (example_ik_franka.py's MJCF of
     gymnasium-robotics' Panda: includes, classes, 20 binary STL meshes;
     skipped, saying why, where the assets are absent): its counts, the
     example's IK reach batched (its first solve, joint_q0 to its first
     target, for each of 4096 problems, then each problem's own point of
     the example's circle from that pose; 2 seeds x 12 LM iterations;
     the example's bound, median error < 0.03), and the
     kitchen scene and the Adroit pen finalized to test_importers.py's
     counts; finalize seconds, solves/s and the error.
 56. the slice's main path: the ant x 1024 filmed by its track cameras
     (replicate(gymnasium's ant, 1024, spacing=(4, 4, 0)), SolverMuJoCo(
     iterations=8, euler) through step, dt 1/240, 4 substeps a frame with
     uniform random ctrl; each world's 64 x 64 camera at its torso plus
     ant.xml's track offset (0, -3, 0.3), looking along +Y, fovy 45
     degrees, posed on the device from body_q and rendered every frame
     through SensorTiledCamera: R = 4,194,304 rays against S = 14,336
     shapes, the camera having no world axis, C.43): a warm-up frame then
     10 frames with one B1 (d = 14) and one B2 a substep and one K1 launch
     a render; finite, unit quaternions, finite channels; the pixel that
     points at the torso centre shows the world's torso in >= 99% of
     worlds, at the analytic sphere distance within 1e-4; 0 host syncs a
     frame; env-steps/s with rendering, render ms, K1 timed at this shape
     (queued and back to back) and its counters read (box tests, boxes
     opened, pairs of each class: by warp, and by each ray's own passes,
     the work its culling left); K1 against its plain twin bit for bit
     (t, shape index, normal; t within 1e-5 max(1, t), normals within
     1e-4 and ties reported beside) on 4,096 rays, whole image rows of 64
     cameras spread over the grid, at this shape (S = 14,336), the twin
     timed on that run, and on the ant x 16 scene (R = 65,536, S = 224),
     primary and shadow rays; device ops a frame and busy share;
 57. the other rendering paths once each at the main path's cameras: (b)
     shadows on the main scene (K1 twice a render, hdr darker; K1 bit for
     bit against its twin on the shadow rays of phase 56's 64 camera
     rows, as the camera makes them); (a) the
     fractal terrain (128 x 128 over 128 m) as a visual-only MESH of
     32,258 triangles (no bake) under the grid, through K2, with (c) a
     12 m heightfield sphere-traced through its bake and (d) a global
     cloud of 256 Gaussians (plain compositing) in one render: each seen,
     finite; K1 bit for bit against its twin on those rows among the
     extra shapes; K2 timed at the render's shape, against its plain twin on
     65,536 of its rays and both against every triangle on 4,096 of them;
     (e) the golden images (tests/golden_data) at tests/test_sensors.py's
     gates; (f) ViewerRTX writes a decodable PNG of the ant scene,
     ViewerBase.pick from a torso's camera returns that torso, ViewerFile
     records 2 frames;
 58. the main path of autograd: the ant x 4096 trained by
     gradient. Roots 0.08 into the ground, open-loop MJCF ctrl u (4096,
     2 frames, 8) from torch.Generator seed 0, uniform in [-1, 1];
     2 frames x 4 substeps of static collide + step_batched (8
     iterations, euler), loss = -mean(root x) + 1e-3 mean(u^2); five
     torch.optim.Adam steps (lr 0.05), one loss.backward() each, every
     count set to 0 before and read after: one B1 and one B2 launch a
     forward substep, one K3 (B1's backward) and one K4 (B2's) a
     backward substep; loss and gradients finite, the loss falls, every
     substep has worlds with an active contact row (their share
     reported); the gradient through the kernels against the plain
     versions' autograd on the card from the same u, ||dg|| / ||g|| <=
     1e-3, worlds whose B2 halvings differ counted and left out; two
     backward passes bit-equal; 0 host syncs in a forward substep (the
     backward's count reported); train steps/s, env-steps/s of forward
     plus backward, the backward/forward ratio, peak memory (frames
     checkpointed above 40 GB) and one profiled train step. (a) K3
     against autograd of the plain version (atol 1e-5, rtol 1e-4, and
     normwise against float64 at most 2x the plain's) for chol_inv_solve
     at d = 14, 23 (W = 4096) and chol_solve at d = 6 (W = 8192), timed
     beside the plain backward and torch.linalg.solve's backward; (b) K4
     against autograd of the plain version (normwise 1e-3 per input,
     NaN where the plain's is) on the ant's captured operands, random
     box and cone, nl = 0, w_other and the humanoid's (32, 17, 23),
     envs of other halvings counted (K4 differentiates the forward that
     B2 saved, whose halvings are B2's) and held to finite gradients
     wherever B2's forward and the plain gradient are finite, timed at
     the ant's and humanoid's from B2's saved forward; B2 with its
     forward saved gives the bits it gives without; K4's and B2's save
     instance's registers and blocks per SM, K4's ptxas lines (registers
     and spill of each instance), and the saved forward's bytes a train
     step;
 59. the main path of USD import: the USD ant x 4096.
     newton_tpu_torch/assets/ant.usda parsed (parse_usda), written to a
     .usdc (write_usdc) and imported from it (ModelBuilder.add_usd; the
     stage's shapes at conaffinity 0, the MJCF ant's ground-only
     contacts), the model equal to the .usda's bit for bit and its
     counts (13 bodies, 13 joints, 14 dofs; the free root's joint comes
     last) to the MJCF ant's; finalize, eval_fk, batch_state, static
     collide + step_batched (8 iterations, euler), 4 substeps of 1/240 s
     a frame, joint_f = 150 u on the 8 hinges (u uniform in [-1, 1] from
     torch.Generator seed 0): 2 warm-up frames, then 20 timed frames with
     every count set to 0 before and read after, one B1 (d = 14) and one
     B2 launch a substep; check_state_valid and nan_sweep after the
     window; a checkpoint after window frame 10 (save_state, load_state
     into model.state() on the card), frames 10-20 replayed from it twice,
     each time with the uninterrupted run's state_digest; a frame through
     the kernels against one through the plain versions (joint_q/body_q
     2e-4, joint_qd 5e-3); B1 (atol 1e-5, rtol 1e-4) and B2 against their
     plain versions on the frame's last operands, timed with
     torch.linalg.solve beside B1; 4 worlds taken with unbatch_env
     stepped 4 substeps on the card and on the CPU port (phase 45's rule);
     two runs of a frame equal by digest; 0 host syncs a frame; one
     profiled frame; an EventTracer(sync=True) line with the stages
     (import, usdc round trip, finalize, warm-up, window, save, load,
     replay), none inside a frame.
 60. the main path of the examples entry point: the humanoid batch x
     4096 through ``python -m newton_tpu_torch.examples``' registry.
     (a) ``init(["robot_humanoid_batch", "--num-worlds", "4096",
     "--viewer", "null"])`` and the registry's ``Example(viewer, args)``
     on the card (replicate + flat step, static collide, 8 iterations,
     euler, 4 substeps of 1/240 s, zero ctrl): one warm-up frame, then 20
     timed frames (``step`` and ``render``) with every count set to 0
     before and read after, one B1 (d = 23) and one B2 launch a substep;
     finite, unit quaternions (roots and bodies, 1e-4) and the example's
     own ``test_final``; a frame through the kernels against one through
     the plain versions (joint_q 2e-4, joint_qd 5e-3; worlds whose B2
     guard halvings differ on some substep's operands left out, at most 1
     in 1000); B1 (atol 1e-5, rtol 1e-4) and B2 against their plain
     versions on the frame's last operands, timed with torch.linalg.solve
     beside B1; 4 worlds of the example on the card against the CPU port
     from the card's state, 4 substeps (phase 45's rule); host syncs a
     frame (reported) and one profiled frame; (b) every other ported
     example through ``main([name, "--viewer", "null", "--test",
     "--num-frames", N])`` in this process, N the JAX sweep's frame count
     (tests/test_examples.py:FRAMES, 8 where it names none), each with
     its seconds and its launches of B1/B2 (B2 where it collides) or
     B3/B4, every count > 0; ``EXAMPLE_CUT``'s eight slowest examples
     run 8 frames without ``--test`` (the phase's time; their line says
     so); B3 and B4 against float64 and timed at the mpm_sand example's
     shapes (N = 640, res 48); (c) ``python -m newton_tpu_torch.examples
     robot_ant --viewer null --num-frames 4 --test`` as a subprocess: exit
     0 and ``test passed``.
Phase 49 holds a world off tolerance against the CPU to a float64 CPU
run (the plain versions of B1 and B2 run float64 on the CPU).
Phases 37-51 report device ms and operations per frame, the busy share,
host syncs per substep and peak memory (49-51 require 0 host syncs).
Phases 21, 24-27 and 32-51 run
one substep twice on the card and require the two results to be equal
bit for bit (every sum whose terms share a destination adds in a fixed
order); phases 32-48 also step 64 worlds (8 for the box pile, 16 for
phase 48; 4 substeps on 45-48) or the particle scenes on the card against
the same on the CPU (joint_q/body_q 2e-4, joint_qd 5e-3; on 45-46 a
world off tolerance on a tie of the contact geometry is held to a
float64 CPU run, and the results count such worlds) and report peak
device memory.
It prints one JSON line listing the kernels (name, route, source,
launches, error, times, and each time's least possible time on an H100
SXM at 700 W from ``kernel_cost``: bound_ms, bound_by, share_of_bound;
library_ms where one PyTorch call computes the same function, else null
with the reason; B1 and B2 also at the humanoid's shapes; B3 timed with
its binning and given bins, B4 given bins, its bound counted on the nodes
it reads; the binning, part of both, with its own entry; then one entry
for each B1 and B2 instance on the paths of phases 13-20 and 22, with
the W it runs at there, B2 on the two-sided groups with w_other, B2 at
the pyramid's uncompacted (288, 0, 36) off the main path; B1 without
the inverse on the equality systems (chol_solve, bound on the solve's
own bytes, beside torch.linalg.solve(A, rhs)), B1 on the sleeping boxes
and the URDF pendulum, B2 with a
warm lam0 on the ant, the boxes and the humanoid; B1 and B2 at each
shape of phases 32-39 and 48-50, B2's non-symmetric form and the
conveyor's moving support among them; K1 at phase 56's shape (its bound
from the work each ray's own culling left, the warps' and the all-pairs
bounds beside), its
plain twin timed on 64 cameras' rows, and at the ant x 16 parity scene,
K2 at phase 57 (a)'s, their bounds from kernel_cost; K3 at phase 58's
three shapes and K4 at the ant's and the humanoid's, the forward that
B2 saves for it beside; B1 and B2 at the USD ant's shapes, phase 59;
B1 and B2 at the humanoid batch's and B3 and B4 at the mpm_sand
example's, phase 60),
then the card
line, then the result line ``{"ok": true,
"device": {...}}``. Any failed phase raises: exit code != 0 and no result
line. Without a CUDA device it exits 2 at once. A ``[details]`` line
carries the per-case errors, the throughput turns, the compiler's
register report and, for B1 and B2 at each main-path shape and each
kernel of B3, B4 and the binning, registers per thread and resident
blocks per SM (and shared memory per block).

    python3 chip_smoke.py --function-times times.json

also writes, at exit, the wall seconds and calls of each function of this
script (inclusive of the functions it calls), keyed by the phase function
that was running: where a phase's time goes.
"""

import functools
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
W = 4096
DT = 1.0 / 240.0
SUBSTEPS = 4
FRAMES = 10
TURN_FRAMES = 2                       # frames per turn of the rate turns
ITERS = 8


# published H100 SXM peaks at 700 W: HBM bytes/s, float32 FLOP/s outside
# the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def kernel_cost(name, W=1, **shape):
    """(bytes, flops) one call of kernel ``name`` must move and do: each
    input read once, each output written once, an FMA counted as 2 FLOPs,
    divisions and square roots as 1. W envs (or one call's particles).

    chol_inv_solve (d): reads Mi and rhs, writes Minv and x; the factor's
        (d-1) d (d+1) / 6 FMAs and the substitutions' d (d-1) (d+1).
    chol_solve (d): reads Mi and rhs, writes x; the factor's FMAs and the
        two substitutions of one column, d (d-1).
    pgs_solve_fused (c, nl, d; iters = 8; w_other = False): reads J,
        Minv, qd, b, act, lam0 and mu, writes lam, dqd and the int32
        halvings (the per-call ld vector is not per env); the MJ = J Minv
        assembly (3c d^2), diag and v_free (2 x 3c d), spectral_iters +
        iters Delassus matvecs (2 x 3c d + nl d each) and dqd (3c d +
        nl d); with ``w_other`` (two-sided contacts) it also reads the 3c
        addends, adds them to the diagonal and does one more FMA per
        contact row in each matvec.
    mpm_p2g (N, C, res): reads base (N, 3) int32, w_ax (N, 3, 3) and vals
        (N, C), writes the dense res^3 x C grid, zeros included; 27 weight
        products (2 each) and 27 C FMAs per particle.
    mpm_g2p (N, C, active_nodes): reads base, w_ax and the C channels of
        the active_nodes grid nodes that some particle's clipped stencil
        touches (``active_nodes``: a gather reads no other node), writes
        (N, C); the same operations.
    mpm_bin (N, tiles, active_tiles): reads base, writes the bins (see
        below); no floating-point work.
    The bins and scratch slots of the MPM kernels are their design's own
    traffic and count in neither bound.
    raycast_closest (R, classes = shapes of each class: plane, sphere,
        box, capsule; shapes of no class are skipped): reads the rays (R x
        24 B) and each shape's transform, scale and class once (44 B),
        writes t, the shape and the normal (20 B a ray). Per (ray, shape)
        pair, what the function needs of the ray in the shape's frame:
        o - p (3) and, for a box or a capsule, two 3x3 rotations (2 x 15;
        the matrix made once a shape), 33; for a plane only the local z
        of o and d, 13; for a sphere no rotation (its test reads only
        dot products), 3. Then the class: plane 1 (a division), sphere 17,
        box 26 (3 reciprocals, the slab test's 12 products and
        differences, 11 min/max), capsule 39 (the cylinder's 19, each
        cap's 10 from the cylinder's partial sums); per ray the winner's
        frame, normal and rotation back, 113. K1 itself does more (two
        quaternion rotations a pair, 63, every class in the shape's
        frame, each cap's sums anew): it rounds as its plain twin does,
        to equal it bit for bit. This counts every pair: the function
        without culling.
    raycast_closest_culled (R, S, boxes, pairs = pairs of each class,
        box_tests): K1 with culling, the work this run's data needs (the
        kernel's per-ray counters: each ray's test of every top box and
        of the groups of the top boxes it passes, the pairs of the groups
        it passes; the kernels line gives the warps' work, every live
        ray charged for what its warp opened, beside it): reads the rays,
        each shape once (44 B and its 4 B place in the order), each box
        once (24 B); per pair its class's cost above, per box test 56
        (the distance bound and margin 14, the coordinates' size 16: 6
        absolute values, 8 maxima, a product and a sum; the grown slab
        test 26), per ray 113.
    chol_backward (d, inverse = True): K3. With the inverse: reads Minv,
        gMinv, x and gx, writes gMi and grhs; grhs = Minv gx (d^2 FMAs),
        T = gMinv Minv and Minv T (2 d^3), G = -(grhs x^T + .) (d^2 each)
        and the fold onto the lower triangle (d^2 / 2 additions). Without
        (chol_solve's backward, grhs given): reads x and grhs, writes gMi.
    pgs_backward (c, nl, d; iters = 8; w_other = False): K4. Reads what
        pgs_solve_fused reads and the cotangents of lam and dqd, writes
        the gradients of J, Minv, qd, b, mu and lam0; the forward's
        operations again (the VJP needs the iterates it is not given),
        then per Delassus matvec its adjoint (the two transposed products
        and the two rank-1 updates of gJ and gMJ: 4 x 3c d + 2 nl d), the
        adjoint of dqd, and the assembly's (gJ += gMJ Minv^T and gMinv +=
        J^T gMJ: 2 x 3c d^2; diag and v_free: 3 x 3c d); with ``w_other``
        its gradient too. This is the function's work from its inputs:
        the iterates that B2 saves for K4 (pgs.save_floats an env) are
        the design's own traffic and count in neither bound.
    raycast_mesh (R, M, nodes, tris, bvh_nodes, leaf_slots, vertices): reads
        the rays, each mesh shape's transform and scale (40 B), the BVH
        once (24 B a node's box, 13 B a leaf slot's indices and mask, 12 B
        a vertex), writes t and the normal (16 B a pair). Per pair: the
        ray into the frame (a 3x3 rotation) and through the scale (33 +
        6), 3 reciprocals, the normal's rescale (12); per node visited the
        slab test (23);
        per triangle tested Moller-Trumbore (52). ``nodes`` and ``tris``
        are the counts of this run's data (the kernel's counters)."""
    f = 4
    if name == "chol_inv_solve":
        d = shape["d"]
        nbytes = 2 * (d * d + d) * f
        fma = (d - 1) * d * (d + 1) // 6 + d * (d - 1) * (d + 1)
        flops = 2 * fma + 2 * d * (d + 1) + d
    elif name == "chol_solve":
        d = shape["d"]
        nbytes = (d * d + 2 * d) * f
        fma = (d - 1) * d * (d + 1) // 6 + d * (d - 1)
        flops = 2 * fma + 2 * d + d
    elif name == "pgs_solve_fused":
        c, nl, d = shape["c"], shape["nl"], shape["d"]
        iters = shape.get("iters", 8)
        r3, r = 3 * c, 3 * c + 2 * nl
        spec = 3 if r < 192 else 8
        nbytes = (r3 * d + d * d + d + 3 * r + c) * f + (r + d) * f + 4
        fma = (r3 * d * d + 2 * r3 * d
               + (spec + iters) * (2 * r3 * d + nl * d) + r3 * d + nl * d)
        flops = 2 * fma
        if shape.get("w_other"):
            nbytes += r3 * f
            flops += r3 + 2 * (spec + iters) * r3
    elif name == "chol_backward":
        d, inv = shape["d"], shape.get("inverse", True)
        if inv:
            nbytes = (3 * d * d + 3 * d) * f
            flops = 4 * d ** 3 + 2 * d * d + 2 * d * d + d * d // 2
        else:
            nbytes = (d * d + 2 * d) * f
            flops = d * d + d * d // 2
    elif name == "pgs_backward":
        c, nl, d = shape["c"], shape["nl"], shape["d"]
        iters = shape.get("iters", 8)
        r3, r = 3 * c, 3 * c + 2 * nl
        spec = 3 if r < 192 else 8
        nbytes = (2 * (r3 * d + d * d + d + 2 * r + c) + 2 * r + d) * f
        fwd = (r3 * d * d + 2 * r3 * d
               + (spec + iters) * (2 * r3 * d + nl * d) + r3 * d + nl * d)
        bwd = ((spec + iters) * (4 * r3 * d + 2 * nl * d) + r3 * d + nl * d
               + 2 * r3 * d * d + 3 * r3 * d)
        flops = 2 * (fwd + bwd)
        if shape.get("w_other"):
            nbytes += 2 * r3 * f
            flops += 2 * r3 + 4 * (spec + iters) * r3
    elif name in ("mpm_p2g", "mpm_g2p"):
        n, ch = shape["N"], shape["C"]
        nodes = shape["res"] ** 3 if name == "mpm_p2g" \
            else shape["active_nodes"]
        nbytes = n * (3 * 4 + 9 * f + ch * f) + nodes * ch * f
        flops = n * (27 * 2 + 27 * ch * 2)
        return nbytes, flops         # one call, not per env
    elif name == "mpm_bin":
        n, K, act = shape["N"], shape["tiles"], shape["active_tiles"]
        # reads base (N, 3) int32; writes the sorted (N, 4) int32, the
        # offsets (K + 1), slot_of (K), nactive and a record (tile, begin,
        # end) per non-empty tile; integer work only
        return n * 12 + n * 16 + (2 * K + 2 + 3 * act) * 4, 0
    elif name == "raycast_closest":
        R, cls = shape["R"], shape["classes"]
        per = (13 + 1, 3 + 17, 33 + 26, 33 + 39)
        nbytes = R * 44 + sum(cls) * 44
        flops = R * (sum(c * k for c, k in zip(cls, per)) + 113)
        return nbytes, flops
    elif name == "raycast_closest_culled":
        per = (13 + 1, 3 + 17, 33 + 26, 33 + 39)
        nbytes = shape["R"] * 44 + shape["S"] * 48 + shape["boxes"] * 24
        flops = (sum(c * k for c, k in zip(shape["pairs"], per))
                 + 56 * shape["box_tests"] + 113 * shape["R"])
        return nbytes, flops
    elif name == "raycast_mesh":
        R, M = shape["R"], shape["M"]
        nbytes = (R * 24 + M * 40 + shape["bvh_nodes"] * 24
                  + shape["leaf_slots"] * 13 + shape["vertices"] * 12
                  + M * R * 16)
        flops = M * R * (39 + 3 + 12) + shape["nodes"] * 23 \
            + shape["tris"] * 52
        return nbytes, flops
    else:
        raise KeyError(name)
    return W * nbytes, W * flops


def active_nodes(base, res):
    """Distinct grid nodes that the particles' 27-node stencils touch, each
    index clipped to [0, res - 1] per axis (duplicates count once)."""
    import torch
    nodes = torch.clamp(base.long()[:, :, None]
                        + torch.arange(3, device=base.device), 0, res - 1)
    flat = ((nodes[:, 0, :, None, None] * res + nodes[:, 1, None, :, None])
            * res + nodes[:, 2, None, None, :])
    touched = torch.zeros(res ** 3, dtype=torch.bool, device=base.device)
    touched[flat.reshape(-1)] = True
    return int(touched.sum())


def bound_ms(nbytes, flops):
    """(least time in ms on an H100 SXM at 700 W, "bytes" or
    "operations"): the larger of bytes over HBM rate and FLOPs over the
    float32 peak."""
    t_b, t_f = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def close(a, b, atol, rtol):
    """(ok, max_abs_err): |a - b| <= atol + rtol |b| elementwise."""
    diff = (a - b).abs()
    ok = bool((diff <= atol + rtol * b.abs()).all())
    return ok, float(diff.max()) if diff.numel() else 0.0


def time_ms(fn, n=20, queued=False):
    """Mean device time of one call, CUDA events around n calls. With
    ``queued`` the stream is first held busy (a spin kernel) for longer
    than the host takes to enqueue the n calls, so that a kernel shorter
    than its wrapper's host-side cost is timed back to back on the device
    and not at the host's launch rate."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    if queued:
        host = time.perf_counter()
        fn()
        host = time.perf_counter() - host
        torch.cuda._sleep(int(spin_cycles_per_ms() * (2e3 * n * host + 5)))
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


@functools.lru_cache(maxsize=None)
def spin_cycles_per_ms():
    """Cycles of torch.cuda._sleep per millisecond on this card."""
    import torch
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1000000)
    t0.record()
    torch.cuda._sleep(10000000)
    t1.record()
    torch.cuda.synchronize()
    return 1e7 / t0.elapsed_time(t1)


def solve_operand(Mi, rhs):
    """[I | rhs] (W, d, d + 1): the right-hand sides that B1 solves for."""
    import torch
    n, d, _ = Mi.shape
    eye = torch.eye(d, dtype=Mi.dtype, device=Mi.device).expand(n, d, d)
    return torch.cat([eye, rhs[:, :, None]], dim=2).contiguous()


def normwise_err(Minv, x, ref):
    """Largest per-env ||[Minv | x] - ref||_F / ||ref||_F (ref float64)."""
    import torch
    got = torch.cat([Minv, x[:, :, None]], dim=2).double()
    return float((torch.linalg.matrix_norm(got - ref)
                  / torch.linalg.matrix_norm(ref)).max())


def library_b1_ms(Mi, rhs):
    """B1's yardstick: one torch.linalg.solve(Mi, [I | rhs]) returns Minv
    and x; [I | rhs] is built outside the timed window. The port never
    calls it."""
    import torch
    B = solve_operand(Mi, rhs)
    return time_ms(lambda: torch.linalg.solve(Mi, B), queued=True)


def phase_b1(dev):
    """Cholesky kernel vs plain on random SPD matrices (A A^T + 2 I):
    elementwise against each other and normwise against a float64 solve
    (the kernel's error at most max(2 x the plain version's, 1e-5))."""
    import numpy as np
    import torch
    from newton_tpu_torch.solvers.generalized import linalg
    rng = np.random.RandomState(1)
    out, norm, times = {}, {}, {}
    for d in (14, 23):
        A = rng.randn(W, d, d).astype(np.float32)
        spd = A @ np.transpose(A, (0, 2, 1)) + 2.0 * np.eye(d, dtype=np.float32)
        Mi = torch.as_tensor(spd, device=dev)
        rhs = torch.as_tensor(rng.randn(W, d).astype(np.float32), device=dev)
        Minv_k, x_k = linalg.chol_inv_solve(Mi, rhs)
        Minv_p, x_p = linalg.chol_inv_solve_plain(Mi, rhs)
        ok1, e1 = close(Minv_k, Minv_p, 1e-5, 1e-4)
        ok2, e2 = close(x_k, x_p, 1e-5, 1e-4)
        if not (ok1 and ok2):
            raise AssertionError(f"B1 d={d}: kernel vs plain off tolerance "
                                 f"(Minv {e1:.3g}, x {e2:.3g})")
        out[d] = max(e1, e2)
        ref = torch.linalg.solve(Mi.double(), solve_operand(Mi, rhs).double())
        nk, np_ = normwise_err(Minv_k, x_k, ref), normwise_err(Minv_p, x_p,
                                                                ref)
        if nk > max(2 * np_, 1e-5):
            raise AssertionError(f"B1 d={d}: normwise error vs float64 "
                                 f"{nk:.3g} > max(2 x plain {np_:.3g}, 1e-5)")
        norm[d] = dict(kernel=nk, plain=np_)
        times[d] = dict(
            ms=time_ms(lambda: linalg.chol_inv_solve(Mi, rhs), queued=True),
            plain_ms=time_ms(lambda: linalg.chol_inv_solve_plain(Mi, rhs)),
            library_ms=library_b1_ms(Mi, rhs))
    return dict(max_abs_err=max(out.values()), per_d=out, normwise=norm,
                times=times, ms=times[14]["ms"],
                plain_ms=times[14]["plain_ms"],
                library_ms=times[14]["library_ms"])


def compare_pgs(args, kw, allow_mismatch):
    """Kernel vs plain PGS on one input set; returns (max lam err, max dqd
    err, envs whose guard halvings differ)."""
    from newton_tpu_torch.solvers.generalized import pgs
    lam_k, dqd_k, h_k = pgs.pgs_solve_fused(*args, **kw, return_halvings=True)
    lam_p, dqd_p, h_p = pgs.pgs_solve_fused_plain(*args, **kw,
                                                  return_halvings=True)
    same = h_k == h_p
    n_diff = int((~same).sum())
    if n_diff > allow_mismatch:
        raise AssertionError(f"B2: {n_diff} envs with different guard "
                             f"halvings (allowed {allow_mismatch})")
    ok1, e1 = close(lam_k[same], lam_p[same], 1e-4, 1e-4)
    ok2, e2 = close(dqd_k[same], dqd_p[same], 1e-3, 1e-3)
    if not (ok1 and ok2):
        raise AssertionError(f"B2: kernel vs plain off tolerance (lam "
                             f"{e1:.3g}, dqd {e2:.3g})")
    return e1, e2, n_diff, int(h_p.sum()), same


def random_pgs_inputs(dev, c, nl, d, seed, n=W):
    """Random PGS operands shaped like the JAX package's interpret-mode
    test: J ~ N(0, 1), one SPD Minv for all n envs, |b|, act ~ 70% on."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    r = 3 * c + 2 * nl
    Minv = rng.randn(d, d)
    Minv = (Minv @ Minv.T + np.eye(d)).astype(np.float32)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x, dtype=np.float32),
                               device=dev)
    args = (t(rng.randn(n, 3 * c, d)), t(np.broadcast_to(Minv, (n, d, d))),
            t(rng.randn(n, d)), t(np.abs(rng.randn(n, r))),
            t(rng.rand(n, r) > 0.3), t(np.abs(rng.rand(n, c))),
            t(np.zeros((n, r))))
    ld = torch.arange(d - nl, d, dtype=torch.int32, device=dev)
    return args, ld


def build_ant(dev):
    import newton_tpu_torch as nt
    b = nt.ModelBuilder()
    b.add_mjcf(os.path.join(nt.ASSET_DIR, "ant.xml"))
    model = b.finalize(dev)
    pipe = nt.CollisionPipeline(model)
    solver = nt.SolverMuJoCo(model, iterations=ITERS, integrator="euler")
    state0 = nt.eval_fk(model, model.joint_q0, model.joint_qd0,
                        model.state())
    return model, pipe, solver, state0


def batched_control(model, ctrl):
    import newton_tpu_torch as nt
    c = model.control()
    n = ctrl.shape[0]
    return nt.Control(
        joint_target_q=c.joint_target_q.expand(n, -1).clone(),
        joint_target_qd=c.joint_target_qd.expand(n, -1).clone(),
        joint_f=c.joint_f.expand(n, -1).clone(), custom={"mjc:ctrl": ctrl})


def ctrl_sampler(model, dev, seed):
    import numpy as np
    import torch
    au = model.structure.mjc_actuation
    lim = np.asarray(au.ctrllimited)
    cr = np.asarray(au.ctrlrange)
    lo = torch.as_tensor(np.where(lim, cr[:, 0], -1.0), dtype=torch.float32,
                         device=dev)
    hi = torch.as_tensor(np.where(lim, cr[:, 1], 1.0), dtype=torch.float32,
                         device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def sample(n):
        u = torch.rand((n, au.n), generator=gen, device=dev)
        return lo + u * (hi - lo)
    return sample


def dropped_state(model, state0, dev, drop=0.08, seed=0):
    """A batched ant state with perturbed coordinates and the root pushed
    ``drop`` into the ground, so that the feet are in contact."""
    import numpy as np
    import torch
    import newton_tpu_torch as nt
    rng = np.random.RandomState(seed)
    sb = nt.batch_state(state0, W)
    q = sb.joint_q.cpu().numpy() + 0.02 * rng.randn(*sb.joint_q.shape)
    q[:, 2] -= drop
    qd = sb.joint_qd.cpu().numpy() + 0.1 * rng.randn(*sb.joint_qd.shape)
    return nt.eval_fk(model, torch.as_tensor(q, dtype=torch.float32,
                                             device=dev),
                      torch.as_tensor(qd, dtype=torch.float32, device=dev),
                      sb)


def phase_b2(dev, model, pipe, solver, state0):
    import torch
    from newton_tpu_torch.solvers.generalized import pgs
    kw0 = dict(iters=ITERS, omega=0.8, diag_scale=1.0, reg=1e-3)
    cases = {}
    worst_lam = worst_dqd = 0.0
    for nl, cone in ((8, False), (8, True), (0, False)):
        args, ld = random_pgs_inputs(dev, 25, nl, 14, seed=2 + nl)
        kw = dict(kw0, c=25, ld=ld, use_cone=cone)
        e1, e2, n_diff, n_halv, _ = compare_pgs(args, kw, W // 1000)
        cases[f"random nl={nl} cone={cone}"] = dict(
            lam_err=e1, dqd_err=e2, guard_mismatch_envs=n_diff,
            halvings=n_halv)
        worst_lam, worst_dqd = max(worst_lam, e1), max(worst_dqd, e2)
    # operands captured from a real ant substep with contacts
    sb = dropped_state(model, state0, dev)
    rec = {}
    ctrl = ctrl_sampler(model, dev, seed=1)(W)
    solver.step_batched(sb, None, batched_control(model, ctrl),
                        pipe.collide(sb), DT, kernels=False, record=rec)
    args, kw = rec["pgs"]
    n_active = int(args[4][:, :25].sum(1).max())
    e1, e2, n_diff, n_halv, _ = compare_pgs(args, kw, 0)
    cases["ant substep, drop 0.08"] = dict(
        lam_err=e1, dqd_err=e2, guard_mismatch_envs=n_diff,
        halvings=n_halv, max_active_contacts=n_active)
    worst_lam, worst_dqd = max(worst_lam, e1), max(worst_dqd, e2)
    ms = time_ms(lambda: pgs.pgs_solve_fused(*args, **kw), queued=True)
    plain_ms = time_ms(lambda: pgs.pgs_solve_fused_plain(*args, **kw))
    return dict(max_abs_err=worst_lam, dqd_max_abs_err=worst_dqd,
                cases=cases, ms=ms, plain_ms=plain_ms), sb, ctrl


def run_frames(model, pipe, solver, state, sample, frames, kernels,
               touched=None):
    """``frames`` frames of SUBSTEPS substeps; ``touched`` (W,) bool, when
    given, gathers which envs had an active contact in some substep."""
    import torch
    for _ in range(frames):
        ctl = batched_control(model, sample(state.joint_q.shape[0]))
        for _ in range(SUBSTEPS):
            contacts = pipe.collide(state)
            if touched is not None:
                touched |= contacts.rigid_contact_mask.any(1)
            state = solver.step_batched(state, None, ctl, contacts, DT,
                                        kernels=kernels)
    torch.cuda.synchronize()
    return state


def check_state(state, label, z_min=0.1):
    """No NaN, unit quaternions within 1e-2 and, unless ``z_min`` is None,
    root z (coordinate 2 of each env's row of joint_q) > ``z_min``."""
    import torch
    for name in ("joint_q", "joint_qd", "body_q", "body_qd"):
        if not bool(torch.isfinite(getattr(state, name)).all()):
            raise AssertionError(f"{label}: non-finite {name}")
    qn = torch.linalg.vector_norm(state.body_q[..., 3:7], dim=-1)
    if float((qn - 1.0).abs().max()) > 1e-2:
        raise AssertionError(f"{label}: non-normalized quaternions")
    if z_min is None:
        return None
    zmin = float(state.joint_q[:, 2].min())
    if zmin <= z_min:
        raise AssertionError(f"{label}: root fell to z = {zmin:.3f}")
    return zmin


def phase_main(dev, model, pipe, solver, state0):
    import torch
    import newton_tpu_torch as nt
    from newton_tpu_torch.solvers.generalized import linalg, pgs
    sample = ctrl_sampler(model, dev, seed=0)
    state = nt.batch_state(state0, W)
    state = run_frames(model, pipe, solver, state, sample, 1, True)  # warm-up
    linalg.chol_inv_solve.launches = 0
    pgs.pgs_solve_fused.launches = 0
    t0 = time.perf_counter()
    state = run_frames(model, pipe, solver, state, sample, FRAMES, True)
    elapsed = time.perf_counter() - t0
    launches = dict(chol_inv_solve=linalg.chol_inv_solve.launches,
                    pgs_solve_fused=pgs.pgs_solve_fused.launches)
    n_sub = FRAMES * SUBSTEPS
    for name, n in launches.items():
        if n != n_sub:
            raise AssertionError(f"main path: {name} launched {n} times in "
                                 f"{n_sub} substeps")
    zmin = check_state(state, "main path")
    # throughput in turns (plain, kernel, kernel, plain), each turn
    # TURN_FRAMES frames continuing its own path's state, so drift on the
    # card hits both paths alike
    plain = run_frames(model, pipe, solver, nt.batch_state(state0, W),
                       sample, 1, False)
    rates = {True: [], False: []}
    for kernels in (False, True, True, False):
        before = (linalg.chol_inv_solve.launches,
                  pgs.pgs_solve_fused.launches)
        t0 = time.perf_counter()
        if kernels:
            state = run_frames(model, pipe, solver, state, sample,
                               TURN_FRAMES, True)
        else:
            plain = run_frames(model, pipe, solver, plain, sample,
                               TURN_FRAMES, False)
        rates[kernels].append(TURN_FRAMES * SUBSTEPS * W
                              / (time.perf_counter() - t0))
        after = (linalg.chol_inv_solve.launches,
                 pgs.pgs_solve_fused.launches)
        if not kernels and after != before:
            raise AssertionError("the plain path launched a kernel")
    check_state(plain, "plain path")
    check_state(state, "kernel path")
    return dict(launches=launches, substeps=n_sub, envs=W,
                root_z_min=zmin, main_env_steps_per_s=n_sub * W / elapsed,
                env_steps_per_s=sum(rates[True]) / 2,
                plain_env_steps_per_s=sum(rates[False]) / 2,
                turns_kernel=rates[True], turns_plain=rates[False]), state


def phase_paths(model, pipe, solver, states, sample):
    """One substep through the kernels and one through the plain versions
    from the same cloned state, ctrl and contacts."""
    out = {}
    for label, state in states.items():
        ctl = batched_control(model, sample(state.joint_q.shape[0]))
        contacts = pipe.collide(state)
        k = solver.step_batched(state.clone(), None, ctl, contacts, DT)
        p = solver.step_batched(state.clone(), None, ctl, contacts, DT,
                                kernels=False)
        errs = {}
        for name, atol in (("joint_q", 2e-4), ("joint_qd", 5e-3),
                           ("body_q", 2e-4)):
            ok, e = close(getattr(k, name), getattr(p, name), atol, atol)
            if not ok:
                raise AssertionError(f"paths ({label}): {name} kernel vs "
                                     f"plain off tolerance ({e:.3g})")
            errs[name] = e
        out[label] = errs
    return out


MPM_N = 32768
MPM_RES = 64
MPM_DT = 4e-4
MPM_WARMUP = 25
MPM_STEPS = 100
MPM_CG_ITERS = 8
MPM_SIDE_STEPS = 10
# one-step tolerances, kernel path vs plain path and vs a float64 plain
# step: tests/test_torch_mpm.py's (absolute), except that mpm:C is held
# relative to its largest entry: its APIC recombination is a cancellation
# whose rounding grows with the node coordinates (res) and with |C|
MPM_TOL = {"particle_q": 1e-6, "particle_qd": 1e-4, "mpm:F": 1e-5}
MPM_C_RTOL = 1e-3


def build_sand(dev, **kw):
    """bench.py --mode mpm's model and solver (bench.py:347-359)."""
    import numpy as np
    import newton_tpu_torch as nt
    rng = np.random.RandomState(0)
    pts = rng.uniform(-0.3, 0.3, (MPM_N, 3))
    pts[:, 2] = rng.uniform(0.05, 0.8, MPM_N)
    b = nt.ModelBuilder()
    b.add_particles(pts, mass=0.002)
    model = b.finalize(dev)
    solver = nt.SolverImplicitMPM(model, grid_lower=(-1, -1, 0),
                                  grid_upper=(1, 1, 2), resolution=MPM_RES,
                                  friction_angle=0.6, young=5e4, **kw)
    return model, solver, solver.init_state(model.state())


def transfer_err(got, ref, S):
    """(ok, max_abs_err) under |got - ref| <= 1e-5 S + 1e-7 (float64)."""
    diff = (got.double() - ref).abs()
    return (bool((diff <= 1e-5 * S + 1e-7).all()),
            float(diff.max()) if diff.numel() else 0.0)


def b34_cases(dev, sand_base, sand_w):
    """Operands of phase 7: random bases over -2..res (border clipping),
    the sand state's bases, every particle in one cell, 64 particles in
    each of 64 cells (one per tile, at its upper edge), and no particles;
    N = 32768 at res 64 unless stated. Returns {label: (base, w_ax, vals,
    grid)}."""
    import numpy as np
    import torch
    rng = np.random.RandomState(5)
    n, res = MPM_N, MPM_RES

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    def i32(a):
        return torch.as_tensor(a, dtype=torch.int32, device=dev)
    vals = f32(rng.randn(n, 13))
    grid = f32(rng.randn(res, res, res, 12))
    rand_w = f32(rng.rand(n, 3, 3))
    cells = np.stack(np.meshgrid(*[np.arange(3, res, 4)] * 3,
                                 indexing="ij"), -1).reshape(-1, 3)
    cases = {
        "random": i32(rng.randint(-2, res + 1, (n, 3))),
        "sand": sand_base,
        "one cell": i32(np.tile([[31, 30, 29]], (n, 1))),
        "64 per cell": i32(np.repeat(cells[:n // 64], 64, axis=0)),
        "empty": i32(np.zeros((0, 3))),
    }
    out = {}
    for label, base in cases.items():
        m = base.shape[0]
        w = sand_w if label == "sand" else rand_w[:m]
        out[label] = (base, w, vals[:m], grid)
    return out


def phase_b34(dev, solver, state):
    """B3/B4 (and the binning) against float64 on each case of
    ``b34_cases``, with the bins passed and without; timings at the sand
    bases."""
    import torch
    from newton_tpu_torch.solvers import mpm_transfer as mt
    res = MPM_RES
    _, sand_base, sand_w, _ = solver.stencil(state.particle_q)
    errs, checks = {}, {}
    for label, (base, w, vals, grid) in b34_cases(dev, sand_base,
                                                  sand_w).items():
        bins = mt.bin_particles(base, res)
        ref_bins = mt.bin_particles_plain(base, res)
        if not all(torch.equal(getattr(bins, name), getattr(ref_bins, name))
                   for name in ("offsets", "slot_of", "records")):
            raise AssertionError(f"binning ({label} bases): kernel offsets "
                                 f"or tile records differ from the plain "
                                 f"version's")
        if not torch.equal(torch.sort(bins.perm).values,
                           torch.arange(base.shape[0], device=dev,
                                        dtype=torch.int32)):
            raise AssertionError(f"binning ({label} bases): not a "
                                 f"permutation")
        w64 = w.double()
        ref_G = mt.p2g_apply_plain(base, w64, vals.double(), res)
        S_G = mt.p2g_apply_plain(base, w64, vals.double().abs(), res)
        ref_P = mt.g2p_apply_plain(base, w64, grid.double())
        S_P = mt.g2p_apply_plain(base, w64, grid.double().abs())
        P = mt.g2p_apply(base, w, grid, bins=bins)
        for name, got, ref, S in (
                ("p2g kernel", mt.p2g_apply(base, w, vals, res, bins=bins),
                 ref_G, S_G),
                ("p2g kernel, own bins", mt.p2g_apply(base, w, vals, res),
                 ref_G, S_G),
                ("p2g plain", mt.p2g_apply_plain(base, w, vals, res), ref_G,
                 S_G),
                ("g2p kernel", P, ref_P, S_P),
                ("g2p plain", mt.g2p_apply_plain(base, w, grid), ref_P,
                 S_P)):
            ok, e = transfer_err(got, ref, S)
            if not ok:
                raise AssertionError(f"B3/B4 {name} ({label} bases) vs the "
                                     f"float64 plain result: off tolerance, "
                                     f"max abs err {e:.3g}")
            errs[f"{name}, {label} bases"] = e
        # G2P sums in a fixed order: bit for bit across calls and binnings
        if not torch.equal(P, mt.g2p_apply(base, w, grid)):
            raise AssertionError(f"B4 ({label} bases): two calls differ")
        if label == "empty" and mt.p2g_apply(base, w, vals, res).any():
            raise AssertionError("B3 with no particles: grid not all zero")
        checks[label] = dict(particles=int(base.shape[0]),
                             tiles=bins.nactive)
    out = dict(errors=errs, cases=checks,
               p2g_max_abs_err=max(v for k, v in errs.items()
                                   if k.startswith("p2g kernel")),
               g2p_max_abs_err=max(v for k, v in errs.items()
                                   if k.startswith("g2p kernel")),
               active_nodes=active_nodes(sand_base, res))
    # the binning kernel's offsets, slot_of and records equal the plain
    # version's exactly (checked above): its max_abs_err is 0
    # times at the main path's shapes and access pattern (sand bases)
    _, w, vals, grid = b34_cases(dev, sand_base, sand_w)["sand"]
    bins = mt.bin_particles(sand_base, res)
    out["p2g_ms"] = time_ms(lambda: mt.p2g_apply(sand_base, w, vals, res),
                            queued=True)
    out["p2g_given_bins_ms"] = time_ms(lambda: mt.p2g_apply(
        sand_base, w, vals, res, bins=bins), queued=True)
    out["bin_ms"] = time_ms(lambda: mt.bin_particles(sand_base, res),
                            queued=True)
    out["bin_plain_ms"] = time_ms(lambda: mt.bin_particles_plain(sand_base,
                                                                 res))
    # the binning's yardstick: one stable torch.sort of the tile keys,
    # made outside the timed window (the port never calls it)
    keys = mt.tile_of(sand_base, res)
    out["bin_library_ms"] = time_ms(lambda: torch.sort(keys, stable=True),
                                    queued=True)
    out["tiles"], out["active_tiles"] = mt.tiles(res)[1], bins.nactive
    out["p2g_plain_ms"] = time_ms(lambda: mt.p2g_apply_plain(
        sand_base, w, vals, res))
    out["g2p_ms"] = time_ms(lambda: mt.g2p_apply(sand_base, w, grid,
                                                 bins=bins), queued=True)
    out["g2p_with_binning_ms"] = time_ms(lambda: mt.g2p_apply(
        sand_base, w, grid), queued=True)
    out["g2p_plain_ms"] = time_ms(lambda: mt.g2p_apply_plain(
        sand_base, w, grid))
    return out


def run_mpm(solver, state, steps, kernels):
    import torch
    for _ in range(steps):
        state = solver.step(state, None, None, None, MPM_DT, kernels=kernels)
    torch.cuda.synchronize()
    return state


def check_sand(state, label, z0_mean=None):
    import torch
    tensors = [state.particle_q, state.particle_qd,
               *[v for v in state.custom.values()]]
    if not all(bool(torch.isfinite(t).all()) for t in tensors):
        raise AssertionError(f"{label}: non-finite MPM state")
    q = state.particle_q
    zmin = float(q[:, 2].min())
    xy = float(q[:, :2].abs().max())
    if zmin <= -0.05:
        raise AssertionError(f"{label}: particle below the floor, z = "
                             f"{zmin:.4f}")
    if xy >= 1.0:
        raise AssertionError(f"{label}: particle left the grid, |x|,|y| = "
                             f"{xy:.4f}")
    zmean = float(q[:, 2].mean())
    if z0_mean is not None and not zmean < z0_mean:
        raise AssertionError(f"{label}: mean z did not drop ({z0_mean:.5f} "
                             f"-> {zmean:.5f})")
    return dict(z_min=zmin, xy_max=xy, z_mean=zmean)


def mpm_launches():
    from newton_tpu_torch.solvers import mpm_transfer as mt
    return dict(p2g_apply=mt.p2g_apply.launches,
                g2p_apply=mt.g2p_apply.launches,
                bin_particles=mt.bin_particles.launches)


def reset_mpm_launches():
    from newton_tpu_torch.solvers import mpm_transfer as mt
    mt.p2g_apply.launches = 0
    mt.g2p_apply.launches = 0
    mt.bin_particles.launches = 0


def phase_mpm_main(solver, state0):
    z0 = float(state0.particle_q[:, 2].mean())
    state = run_mpm(solver, state0.clone(), MPM_WARMUP, True)
    reset_mpm_launches()
    t0 = time.perf_counter()
    state = run_mpm(solver, state, MPM_STEPS, True)
    elapsed = time.perf_counter() - t0
    launches = mpm_launches()
    for name, n in launches.items():
        if n != MPM_STEPS:
            raise AssertionError(f"MPM main path: {name} launched {n} times "
                                 f"in {MPM_STEPS} steps")
    gates = check_sand(state, "MPM main path", z0)
    # throughput in turns (plain, kernel, kernel, plain), each turn
    # MPM_STEPS steps continuing its own path's state
    plain = state.clone()
    rates = {True: [], False: []}
    for kernels in (False, True, True, False):
        before = mpm_launches()
        t0 = time.perf_counter()
        if kernels:
            state = run_mpm(solver, state, MPM_STEPS, True)
        else:
            plain = run_mpm(solver, plain, MPM_STEPS, False)
        rates[kernels].append(MPM_N * MPM_STEPS / (time.perf_counter() - t0))
        if not kernels and mpm_launches() != before:
            raise AssertionError("the plain MPM path launched a kernel")
    check_sand(plain, "MPM plain path", z0)
    check_sand(state, "MPM kernel path", z0)
    return dict(launches=launches, steps=MPM_STEPS, particles=MPM_N,
                gates=gates, z0_mean=z0,
                main_particle_steps_per_s=MPM_N * MPM_STEPS / elapsed,
                particle_steps_per_s=sum(rates[True]) / 2,
                plain_particle_steps_per_s=sum(rates[False]) / 2,
                turns_kernel=rates[True], turns_plain=rates[False]), state


def phase_mpm_side(dev):
    """The CG and implicit-rheology paths at the main path's size."""
    out = {}
    for label, kw, per_step in (
            ("cg", dict(implicit_iterations=MPM_CG_ITERS),
             1 + MPM_CG_ITERS + 1),
            ("rheology", dict(rheology="implicit"), 1)):
        _, solver, state = build_sand(dev, **kw)
        reset_mpm_launches()
        t0 = time.perf_counter()
        state = run_mpm(solver, state, MPM_SIDE_STEPS, True)
        elapsed = time.perf_counter() - t0
        launches = mpm_launches()
        for name, n in launches.items():
            want = 1 if name == "bin_particles" else per_step
            if n != want * MPM_SIDE_STEPS:
                raise AssertionError(
                    f"MPM {label} path: {name} launched {n} times in "
                    f"{MPM_SIDE_STEPS} steps, expected {want} per step")
        out[label] = dict(launches=launches, per_step=per_step,
                          gates=check_sand(state, f"MPM {label} path"),
                          particle_steps_per_s=MPM_N * MPM_SIDE_STEPS
                          / elapsed)
    return out


def phase_mpm_paths(solver, state):
    """One MPM step through the kernels, one through the plain versions and
    one plain step in float64, all from the same cloned state."""
    import dataclasses
    import torch
    k = solver.step(state.clone(), None, None, None, MPM_DT)
    p = solver.step(state.clone(), None, None, None, MPM_DT, kernels=False)
    s64 = dataclasses.replace(
        state, particle_q=state.particle_q.double(),
        particle_qd=state.particle_qd.double(),
        custom={n: v.double() for n, v in state.custom.items()})
    d = solver.step(s64, None, None, None, MPM_DT, kernels=False)

    def get(s, name):
        return s.custom[name] if name.startswith("mpm:") else getattr(s, name)
    c_max = float(get(d, "mpm:C").abs().max())
    tols = dict(MPM_TOL, **{"mpm:C": MPM_C_RTOL * max(1.0, c_max)})
    errs = {}
    for name, atol in tols.items():
        e = {}
        for label, a, b in (("kernel_vs_plain", get(k, name), get(p, name)),
                            ("kernel_vs_f64", get(k, name).double(),
                             get(d, name)),
                            ("plain_vs_f64", get(p, name).double(),
                             get(d, name))):
            ok, e[label] = close(a, b, atol, 0.0)
            if not ok:
                raise AssertionError(f"MPM paths: {name} {label} off "
                                     f"tolerance ({e[label]:.3g} > "
                                     f"{atol:.3g})")
        errs[name] = dict(e, tol=atol)
    if not bool(torch.isfinite(get(k, "mpm:C")).all()):
        raise AssertionError("MPM paths: non-finite kernel step")
    return dict(errors=errs, c_max=c_max)


HUMANOID_W = 4096
HUMANOID_WARMUP = 10
LYING_Q = (0.5 ** 0.5, 0.0, 0.0, 0.5 ** 0.5)    # root turned 90 deg about x


def build_humanoid(dev, contact_cap=None):
    import newton_tpu_torch as nt
    b = nt.ModelBuilder()
    b.add_mjcf(os.path.join(nt.ASSET_DIR, "humanoid.xml"))
    model = b.finalize(dev)
    pipe = nt.CollisionPipeline(model)
    solver = nt.SolverMuJoCo(model, iterations=ITERS, integrator="euler",
                             contact_cap=contact_cap)
    return model, pipe, solver


def humanoid_reset(model, dev, seed, lying_z=None):
    """Batched humanoid state at joint_q0 plus gymnasium's reset noise
    (uniform +-0.01 on joint_q and joint_qd), or laid on its side with the
    root at height ``lying_z``."""
    import torch
    import newton_tpu_torch as nt
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    n = HUMANOID_W

    def noise(k):
        return 0.02 * torch.rand((n, k), generator=gen, device=dev) - 0.01
    q = model.joint_q0.expand(n, -1) + noise(model.joint_coord_count)
    qd = model.joint_qd0.expand(n, -1) + noise(model.joint_dof_count)
    if lying_z is not None:
        q[:, 2] = lying_z
        q[:, 3:7] = torch.tensor(LYING_Q, device=dev)
    q[:, 3:7] = q[:, 3:7] / torch.linalg.vector_norm(q[:, 3:7], dim=1,
                                                     keepdim=True)
    return nt.eval_fk(model, q, qd, nt.batch_state(model.state(), n))


def phase_humanoid_main(dev, model, pipe, solver):
    import torch
    from newton_tpu_torch.solvers.generalized import linalg, pgs
    sample = ctrl_sampler(model, dev, seed=10)
    state = humanoid_reset(model, dev, seed=11)
    state = run_frames(model, pipe, solver, state, sample, HUMANOID_WARMUP,
                       True)
    touched = torch.zeros(HUMANOID_W, dtype=torch.bool, device=dev)
    linalg.chol_inv_solve.launches = 0
    pgs.pgs_solve_fused.launches = 0
    t0 = time.perf_counter()
    state = run_frames(model, pipe, solver, state, sample, FRAMES, True,
                       touched)
    elapsed = time.perf_counter() - t0
    launches = dict(chol_inv_solve=linalg.chol_inv_solve.launches,
                    pgs_solve_fused=pgs.pgs_solve_fused.launches)
    n_sub = FRAMES * SUBSTEPS
    for name, n in launches.items():
        if n != n_sub:
            raise AssertionError(f"humanoid main path: {name} launched {n} "
                                 f"times in {n_sub} substeps")
    zmin = check_state(state, "humanoid main path", z_min=0.3)
    end_state = state
    # random ctrl flings the legs, so at any one instant ~20% of envs touch
    # nothing, and a few swing their legs up before landing and touch
    # nothing in the whole window (5 of 4096 on an H100): at least 99%
    # must have touched something
    untouched = int((~touched).sum())
    if untouched > HUMANOID_W // 100:
        raise AssertionError(f"humanoid main path: {untouched} envs without "
                             "an active contact in the window")
    n_act = pipe.collide(state).rigid_contact_mask.sum(1)
    # throughput in turns, as phase 5; the plain path starts from a copy
    # of the kernel path's state at the window's end
    plain = state.clone()
    rates = {True: [], False: []}
    for kernels in (False, True, True, False):
        before = (linalg.chol_inv_solve.launches,
                  pgs.pgs_solve_fused.launches)
        t0 = time.perf_counter()
        if kernels:
            state = run_frames(model, pipe, solver, state, sample,
                               TURN_FRAMES, True)
        else:
            plain = run_frames(model, pipe, solver, plain, sample,
                               TURN_FRAMES, False)
        rates[kernels].append(TURN_FRAMES * SUBSTEPS * HUMANOID_W
                              / (time.perf_counter() - t0))
        after = (linalg.chol_inv_solve.launches,
                 pgs.pgs_solve_fused.launches)
        if not kernels and after != before:
            raise AssertionError("the humanoid plain path launched a kernel")
    # after the turns the humanoid lies on the floor
    check_state(plain, "humanoid plain path", z_min=0.05)
    check_state(state, "humanoid kernel path", z_min=0.05)
    return dict(launches=launches, substeps=n_sub, envs=HUMANOID_W,
                root_z_min=zmin, envs_untouched_in_window=untouched,
                envs_in_contact_at_end=int((n_act > 0).sum()),
                active_contacts_mean=float(n_act.float().mean()),
                active_contacts_max=int(n_act.max()),
                main_env_steps_per_s=n_sub * HUMANOID_W / elapsed,
                env_steps_per_s=sum(rates[True]) / 2,
                plain_env_steps_per_s=sum(rates[False]) / 2,
                turns_kernel=rates[True], turns_plain=rates[False]), \
        end_state


def humanoid_substep_case(model, pipe, solver, state, ctrl):
    """One substep through the kernels and one through the plain versions
    from one cloned state and ctrl; envs whose guard halvings differ are
    counted (at most W / 1000) and left out of the tolerance. Returns the
    errors and the kernels' captured operands."""
    from newton_tpu_torch.solvers.generalized import linalg
    ctl = batched_control(model, ctrl)
    contacts = pipe.collide(state)
    rec = {}
    k = solver.step_batched(state.clone(), None, ctl, contacts, DT,
                            record=rec)
    p = solver.step_batched(state.clone(), None, ctl, contacts, DT,
                            kernels=False)
    args, kw = rec["pgs"]
    e_lam, e_dqd, n_diff, n_halv, same = compare_pgs(args, kw,
                                                     HUMANOID_W // 1000)
    chol = [close(a, b, 1e-5, 1e-4) for a, b in zip(
        linalg.chol_inv_solve(*rec["chol"]),
        linalg.chol_inv_solve_plain(*rec["chol"]))]
    e_chol = max(e for _, e in chol)
    if not all(ok for ok, _ in chol):
        raise AssertionError(f"humanoid B1: kernel vs plain off tolerance "
                             f"on the captured operands ({e_chol:.3g})")
    errs = dict(pgs_lam=e_lam, pgs_dqd=e_dqd, chol=e_chol,
                guard_mismatch_envs=n_diff, halvings=n_halv,
                active_contacts_max=int(contacts.rigid_contact_mask.sum(1)
                                        .max()),
                rows=int(args[3].shape[1]))
    for name, atol in (("joint_q", 2e-4), ("joint_qd", 5e-3),
                       ("body_q", 2e-4)):
        ok, e = close(getattr(k, name)[same], getattr(p, name)[same], atol,
                      atol)
        if not ok:
            raise AssertionError(f"humanoid paths: {name} kernel vs plain "
                                 f"off tolerance ({e:.3g})")
        errs[name] = e
    return errs, rec


def phase_humanoid_paths(dev, model, pipe, solver, end_state):
    from newton_tpu_torch.solvers.generalized import linalg, pgs
    sample = ctrl_sampler(model, dev, seed=12)
    lying = humanoid_reset(model, dev, seed=13, lying_z=0.1)
    out, recs = {}, {}
    out["a main-path end"], recs["a"] = humanoid_substep_case(
        model, pipe, solver, end_state, sample(HUMANOID_W))
    for key, label, cap in (("b", "b lying, contact_cap 8", 8),
                            ("c", "c lying, uncompacted", 0)):
        _, pipe_c, solver_c = build_humanoid(dev, contact_cap=cap)
        out[label], recs[key] = humanoid_substep_case(
            model, pipe_c, solver_c, lying, sample(HUMANOID_W))
    if out["b lying, contact_cap 8"]["active_contacts_max"] <= 8:
        raise AssertionError("humanoid paths: case b dropped no active "
                             "contact")
    if out["c lying, uncompacted"]["rows"] != 3 * 192 + 2 * 17:
        raise AssertionError("humanoid paths: case c is not uncompacted")
    # kernel times at the humanoid's shapes, on the captured operands
    Mi, rhs = recs["a"]["chol"]
    times = dict(
        b1_ms=time_ms(lambda: linalg.chol_inv_solve(Mi, rhs), queued=True),
        b1_plain_ms=time_ms(lambda: linalg.chol_inv_solve_plain(Mi, rhs)),
        b1_library_ms=library_b1_ms(Mi, rhs))
    for key, name in (("a", "b2"), ("c", "b2_uncompacted")):
        args, kw = recs[key]["pgs"]
        times[f"{name}_ms"] = time_ms(
            lambda: pgs.pgs_solve_fused(*args, **kw), queued=True)
        times[f"{name}_plain_ms"] = time_ms(
            lambda: pgs.pgs_solve_fused_plain(*args, **kw), n=10)
    smem = {key: pgs_smem(recs[key]["pgs"]) for key in ("a", "c")}
    return dict(cases=out, times=times, smem_bytes=smem)


WORLDS = 8192
CARTPOLE_ITERS = 4
CARTPOLE_SLIDER = 1.0                 # inverted_pendulum.xml: range -1 1
CHAIN_SUBSTEPS = 8
STEP_VS_BATCHED_TOL = 1e-6


def build_replicated(dev, xml, n, iterations, contact_cap=None,
                     integrator="euler"):
    """``replicate(robot, n)`` -> finalize -> CollisionPipeline ->
    SolverMuJoCo, the reference's KPI scene; returns the host setup time
    too."""
    import newton_tpu_torch as nt
    t0 = time.perf_counter()
    robot = nt.ModelBuilder()
    robot.add_mjcf(os.path.join(nt.ASSET_DIR, xml))
    b = nt.ModelBuilder()
    b.replicate(robot, n)
    model = b.finalize(dev)
    pipe = nt.CollisionPipeline(model)
    solver = nt.SolverMuJoCo(model, iterations=iterations,
                             integrator=integrator, contact_cap=contact_cap)
    return model, pipe, solver, time.perf_counter() - t0


def flat_reset(model, dev, seed, noise=0.01):
    """The flat state of every world at joint_q0 plus gymnasium's reset
    noise (uniform +-noise on joint_q and joint_qd), free-joint
    quaternions renormalized."""
    import numpy as np
    import torch
    import newton_tpu_torch as nt
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def u(x):
        return x + 2 * noise * torch.rand(x.shape, generator=gen,
                                          device=dev) - noise
    q, qd = u(model.joint_q0), u(model.joint_qd0)
    st = model.structure
    free = st.joint_q_start[:-1][st.joint_type == int(nt.JointType.FREE)]
    if len(free):
        idx = torch.as_tensor(free[:, None] + np.arange(3, 7), device=dev)
        quat = q[idx]
        q[idx] = quat / torch.linalg.vector_norm(quat, dim=1, keepdim=True)
    return nt.eval_fk(model, q, qd, model.state())


def run_flat_frames(model, pipe, solver, state, sample, frames, kernels,
                    touched=None, dt=DT):
    """``frames`` frames of SUBSTEPS ``step`` calls on a flat multi-world
    state, new uniform mjc:ctrl each frame; ``touched`` (N,) bool, when
    given, gathers which worlds had an active contact in some substep."""
    seen = None if touched is None else (solver.tables.row_slots, touched)
    return run_steps(solver, state, model.control(), frames * SUBSTEPS, dt,
                     kernels, pipe=pipe, sample=sample, touched=seen)


def check_flat(state, n, label, root_z=None):
    """check_state on a flat state of n worlds (each world's coordinates a
    row of joint_q)."""
    import dataclasses
    return check_state(dataclasses.replace(
        state, joint_q=state.joint_q.view(n, -1)), label, root_z)


def kernel_launches():
    from newton_tpu_torch.solvers.generalized import linalg, pgs
    return (linalg.chol_inv_solve.launches, pgs.pgs_solve_fused.launches)


def reset_robot_launches():
    from newton_tpu_torch.solvers.generalized import linalg, pgs
    linalg.chol_inv_solve.launches = 0
    linalg.chol_solve.launches = 0
    pgs.pgs_solve_fused.launches = 0


def solve_launches():
    """Launches of B1 without the inverse (``chol_solve``: the equality
    rows' systems)."""
    from newton_tpu_torch.solvers.generalized import linalg
    return linalg.chol_solve.launches


def flat_turns(model, pipe, solver, state, plain, sample, n, dt=DT):
    """env-steps/s of the kernel and plain paths in turns, TURN_FRAMES
    frames each (see ``turns``)."""
    return turns(solver, state, plain, model.control(),
                 TURN_FRAMES * SUBSTEPS,
                 n, dt, pipe=pipe, sample=sample)


def flat_paths(model, pipe, solver, state, sample, label, dt=DT):
    """One ``step`` through the kernels and one through the plain versions
    from one cloned flat state and ctrl; B2 is held against its plain
    version on the step's operands, and rows whose guard halvings differ
    are counted (at most N / 1000) and left out."""
    ctl = model.control()
    ctl.custom["mjc:ctrl"] = sample(1)[0]
    contacts = pipe.collide(state)
    rec = {}
    k = solver.step(state.clone(), None, ctl, contacts, dt, record=rec)
    p = solver.step(state.clone(), None, ctl, contacts, dt, kernels=False)
    n = solver.group.n
    errs, rows_ok = {}, None
    if "pgs" in rec:
        e_lam, e_dqd, n_diff, _, rows_ok = compare_pgs(*rec["pgs"],
                                                       n // 1000)
        errs.update(pgs_lam=e_lam, pgs_dqd=e_dqd, guard_mismatch_rows=n_diff)
    for name, atol in (("joint_q", 2e-4), ("joint_qd", 5e-3),
                       ("body_q", 2e-4)):
        a = getattr(k, name).view(n, -1)
        b = getattr(p, name).view(n, -1)
        if rows_ok is not None:
            a, b = a[rows_ok], b[rows_ok]
        ok, e = close(a, b, atol, atol)
        if not ok:
            raise AssertionError(f"{label}: {name} kernel vs plain step "
                                 f"off tolerance ({e:.3g})")
        errs[name] = e
    return errs


def b1_times(Mi, rhs):
    from newton_tpu_torch.solvers.generalized import linalg
    return dict(
        ms=time_ms(lambda: linalg.chol_inv_solve(Mi, rhs), queued=True),
        plain_ms=time_ms(lambda: linalg.chol_inv_solve_plain(Mi, rhs),
                         n=10),
        library_ms=library_b1_ms(Mi, rhs))


def b1s_times(A, rhs):
    """Times of B1 without the inverse, its plain version, and the library
    call that computes the same function, torch.linalg.solve(A, rhs)."""
    import torch
    from newton_tpu_torch.solvers.generalized import linalg
    return dict(
        ms=time_ms(lambda: linalg.chol_solve(A, rhs), queued=True),
        plain_ms=time_ms(lambda: linalg.chol_solve_plain(A, rhs), n=10),
        library_ms=time_ms(lambda: torch.linalg.solve(A, rhs), queued=True))


def b1s_check(A, rhs, label):
    """B1 without the inverse against its plain version on captured
    operands: within atol 1e-5, rtol 1e-4 (and whether bit for bit
    equal)."""
    import torch
    from newton_tpu_torch.solvers.generalized import linalg
    got = linalg.chol_solve(A, rhs)
    ref = linalg.chol_solve_plain(A, rhs)
    ok, err = close(got, ref, 1e-5, 1e-4)
    if not ok:
        raise AssertionError(f"{label} B1 solve: kernel vs plain off "
                             f"tolerance ({err:.3g})")
    return err, torch.equal(got, ref)


def b1_check(Mi, rhs, label):
    """B1 against its plain version on captured operands: within atol
    1e-5, rtol 1e-4 (and whether bit for bit equal)."""
    import torch
    from newton_tpu_torch.solvers.generalized import linalg
    got = linalg.chol_inv_solve(Mi, rhs)
    ref = linalg.chol_inv_solve_plain(Mi, rhs)
    res = [close(a, b, 1e-5, 1e-4) for a, b in zip(got, ref)]
    err = max(e for _, e in res)
    if not all(ok for ok, _ in res):
        raise AssertionError(f"{label} B1: kernel vs plain off tolerance "
                             f"({err:.3g})")
    return err, all(torch.equal(a, b) for a, b in zip(got, ref))


def phase_cartpole(dev):
    """Cartpole x 8192 through replicate + step: B1 at d = 2 (the padded
    8-row instance) once per substep, the limits-only solve, no B2."""
    import torch
    from newton_tpu_torch.solvers.generalized import linalg
    model, pipe, solver, setup_s = build_replicated(
        dev, "inverted_pendulum.xml", WORLDS, CARTPOLE_ITERS)
    if model.structure.rigid_contact_max != 0:
        raise AssertionError("cartpole: expected no contact pairs")
    sample = ctrl_sampler(model, dev, seed=20)
    state = flat_reset(model, dev, seed=21)
    plain = state.clone()
    rec = {}
    ctl = model.control()
    ctl.custom["mjc:ctrl"] = sample(1)[0]
    solver.step(state, None, ctl, pipe.collide(state), DT, record=rec)
    Mi, rhs = rec["chol"]
    if (tuple(Mi.shape) != (WORLDS, 2, 2) or "pgs" in rec
            or "limits" not in rec or linalg.kernel_instance(2) != "reg8"):
        raise AssertionError("cartpole: the substep is not B1 at d = 2 "
                             "(reg8) plus the limits-only solve")
    state = run_flat_frames(model, pipe, solver, state, sample, 1, True)
    reset_robot_launches()
    t0 = time.perf_counter()
    state = run_flat_frames(model, pipe, solver, state, sample, FRAMES,
                            True)
    elapsed = time.perf_counter() - t0
    n_sub = FRAMES * SUBSTEPS
    launches = dict(zip(("chol_inv_solve", "pgs_solve_fused"),
                        kernel_launches()))
    if launches != dict(chol_inv_solve=n_sub, pgs_solve_fused=0):
        raise AssertionError(f"cartpole: launches {launches} in {n_sub} "
                             "substeps, expected B1 once per substep and "
                             "no B2")
    check_flat(state, WORLDS, "cartpole")
    slider = float(state.joint_q.view(WORLDS, 2)[:, 0].abs().max())
    # the limit rows are Baumgarte-stabilized velocity constraints: the
    # slider may pass its range by what one substep of the ctrl's force
    # carries before the row acts, a few millimetres
    if slider > CARTPOLE_SLIDER + 0.05:
        raise AssertionError(f"cartpole: slider at {slider:.4f}, past its "
                             f"range {CARTPOLE_SLIDER} + 0.05")
    plain = run_flat_frames(model, pipe, solver, plain, sample, 1, False)
    rates, state, plain = flat_turns(model, pipe, solver, state, plain,
                                     sample, WORLDS)
    check_flat(plain, WORLDS, "cartpole plain path")
    errs = flat_paths(model, pipe, solver, state, sample, "cartpole")
    b1_err, b1_exact = b1_check(Mi, rhs, "cartpole")
    return dict(launches=launches, substeps=n_sub, worlds=WORLDS,
                setup_s=setup_s, slider_max=slider,
                main_env_steps_per_s=n_sub * WORLDS / elapsed,
                env_steps_per_s=sum(rates[True]) / 2,
                plain_env_steps_per_s=sum(rates[False]) / 2,
                turns_kernel=rates[True], turns_plain=rates[False],
                paths=errs, b1_max_abs_err=b1_err, b1_bit_exact=b1_exact,
                b1=b1_times(Mi, rhs))


def phase_humanoid_worlds(dev):
    """Humanoid x 8192 through replicate + step, as phase 11 runs the
    batched humanoid; then step against step_batched of a one-world
    humanoid on the same worlds, and the phase's peak device memory."""
    import torch
    from newton_tpu_torch.solvers.generalized import pgs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model, pipe, solver, setup_s = build_replicated(dev, "humanoid.xml",
                                                    WORLDS, ITERS)
    sample = ctrl_sampler(model, dev, seed=30)
    state = flat_reset(model, dev, seed=31)
    state = run_flat_frames(model, pipe, solver, state, sample,
                            HUMANOID_WARMUP, True)
    rec = {}
    ctl = model.control()
    ctl.custom["mjc:ctrl"] = sample(1)[0]
    solver.step(state, None, ctl, pipe.collide(state), DT, record=rec)
    (J, *_), kw = rec["pgs"]
    shape = (kw["c"], int(kw["ld"].numel()), J.shape[2])
    if (tuple(rec["chol"][0].shape) != (WORLDS, 23, 23)
            or J.shape[0] != WORLDS or shape != (32, 17, 23)
            or pgs.kernel_instance(*shape) != "reg24"):
        raise AssertionError(f"humanoid worlds: B1 {rec['chol'][0].shape}, "
                             f"B2 {shape}; expected d = 23 and (32, 17, 23)"
                             f" at {WORLDS} worlds")
    touched = torch.zeros(WORLDS, dtype=torch.bool, device=dev)
    reset_robot_launches()
    t0 = time.perf_counter()
    state = run_flat_frames(model, pipe, solver, state, sample, FRAMES,
                            True, touched)
    elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n_sub = FRAMES * SUBSTEPS
    launches = dict(zip(("chol_inv_solve", "pgs_solve_fused"),
                        kernel_launches()))
    if set(launches.values()) != {n_sub}:
        raise AssertionError(f"humanoid worlds: launches {launches} in "
                             f"{n_sub} substeps")
    zmin = check_flat(state, WORLDS, "humanoid worlds", root_z=0.3)
    untouched = int((~touched).sum())
    if untouched > WORLDS // 100:
        raise AssertionError(f"humanoid worlds: {untouched} worlds without "
                             "an active contact in the window")
    end_state = state
    plain = state.clone()
    rates, state, plain = flat_turns(model, pipe, solver, state, plain,
                                     sample, WORLDS)
    check_flat(plain, WORLDS, "humanoid worlds plain path", root_z=0.05)
    check_flat(state, WORLDS, "humanoid worlds kernel path", root_z=0.05)
    args, kw = rec["pgs"]
    e_lam, e_dqd, n_diff, _, _ = compare_pgs(args, kw, WORLDS // 1000)
    errs = flat_paths(model, pipe, solver, end_state, sample,
                      "humanoid worlds")
    b1_err, b1_exact = b1_check(*rec["chol"], "humanoid worlds")
    agree = step_vs_batched(model, pipe, solver, end_state, sample,
                            build_humanoid(dev))
    Mi, rhs = rec["chol"]
    times = dict(b1=b1_times(Mi, rhs),
                 b2_ms=time_ms(lambda: pgs.pgs_solve_fused(*args, **kw),
                               queued=True),
                 b2_plain_ms=time_ms(lambda: pgs.pgs_solve_fused_plain(
                     *args, **kw), n=10))
    return dict(launches=launches, substeps=n_sub, worlds=WORLDS,
                setup_s=setup_s, root_z_min=zmin,
                worlds_untouched_in_window=untouched,
                peak_memory_bytes=peak,
                main_env_steps_per_s=n_sub * WORLDS / elapsed,
                env_steps_per_s=sum(rates[True]) / 2,
                plain_env_steps_per_s=sum(rates[False]) / 2,
                turns_kernel=rates[True], turns_plain=rates[False],
                paths=errs, pgs_lam_err=e_lam, pgs_dqd_err=e_dqd,
                guard_mismatch_rows=n_diff, b1_max_abs_err=b1_err,
                b1_bit_exact=b1_exact, step_vs_batched=agree, times=times)


def step_vs_batched(model, pipe, solver, state, sample, one_world,
                    substeps=4, dt=DT):
    """``step`` on the replicated model against ``step_batched`` of the
    one-world robot ``one_world`` (model, pipe, solver) on the same worlds
    (its batched state is a view of the flat one), substep by substep,
    each path continuing its own state: the same kernels on the same
    operands."""
    import torch
    import newton_tpu_torch as nt
    n = WORLDS
    one, pipe1, solver1 = one_world
    sb = nt.State(**{f: getattr(state, f).view(n, *getattr(one.state(), f)
                                                .shape)
                     for f in ("body_q", "body_qd", "body_f", "joint_q",
                               "joint_qd")},
                  particle_q=state.particle_q, particle_qd=state.particle_qd,
                  particle_f=state.particle_f)
    ctl = model.control()
    worst = {}
    for _ in range(substeps):
        ctl.custom["mjc:ctrl"] = sample(1)[0]
        ctl_b = batched_control(one, ctl.custom["mjc:ctrl"].view(n, -1))
        state = solver.step(state, None, ctl, pipe.collide(state), dt)
        sb = solver1.step_batched(sb, None, ctl_b, pipe1.collide(sb), dt)
        for name in ("joint_q", "joint_qd", "body_q", "body_qd"):
            d = float((getattr(state, name).view(n, -1)
                       - getattr(sb, name).reshape(n, -1)).abs().max())
            worst[name] = max(worst.get(name, 0.0), d)
    torch.cuda.synchronize()
    if max(worst.values()) > STEP_VS_BATCHED_TOL:
        raise AssertionError(f"step vs step_batched: {worst} > "
                             f"{STEP_VS_BATCHED_TOL}")
    return worst


def build_chain(dev, links, contact_cap=None):
    """A chain of ``links`` capsule links (0.1 m, radius 0.03) along x with
    a free root and revolute joints alternately about y and z, limited to
    +-0.5 rad, lying 5 mm into a ground plane: d = links + 5 dofs, nl =
    links - 1 limit rows, two plane contact slots per link (the links do
    not collide with each other)."""
    import numpy as np
    import newton_tpu_torch as nt
    from newton_tpu_torch.core.host_math import np_transform
    b = nt.ModelBuilder()
    b.add_ground_plane(cfg=nt.ShapeConfig(contype=2, conaffinity=1))
    link = nt.ShapeConfig(contype=1, conaffinity=2)
    prev = -1
    for i in range(links):
        body = b.add_body(xform=np_transform(p=[0.1 * i, 0.0, 0.025]))
        b.add_shape_capsule(body, radius=0.03, half_height=0.05, axis="X",
                            cfg=link)
        if prev < 0:
            b.add_joint_free(body)
        else:
            b.add_joint_revolute(prev, body, xform_p=np_transform(
                p=np.array([0.1, 0.0, 0.0])), axis="YZ"[i % 2],
                limit_lower=-0.5, limit_upper=0.5)
        prev = body
    model = b.finalize(dev)
    return (model, nt.CollisionPipeline(model),
            nt.SolverMuJoCo(model, iterations=ITERS, integrator="euler",
                            contact_cap=contact_cap))


def phase_chains(dev):
    """ROADMAP C.1's shapes on a path: a 40-link chain (d = 45: B1's
    generic instance in shared memory, B2 (32, 39, 45) on the shared-memory
    path) at W = 1024 and a 165-link chain (d = 170: B1 and B2 in global
    scratch) at W = 64, each through step_batched, with the kernels held
    against their plain versions on the captured operands; then B2 alone
    at (192, 40, 48), a block state above 227 KB, on random operands."""
    import torch
    import newton_tpu_torch as nt
    from newton_tpu_torch.solvers.generalized import linalg, pgs
    out = {}
    for links, n_env, b1_inst, b2_inst in (
            (40, 1024, "generic_smem", "smem256"),
            (165, 64, "generic_global", "global256")):
        model, pipe, solver = build_chain(dev, links)
        gen = torch.Generator(device=dev)
        gen.manual_seed(links)
        q = model.joint_q0.expand(n_env, -1) + 0.02 * torch.rand(
            (n_env, model.joint_coord_count), generator=gen, device=dev)
        q[:, 3:7] = q[:, 3:7] / torch.linalg.vector_norm(
            q[:, 3:7], dim=1, keepdim=True)
        state = nt.eval_fk(model, q, torch.zeros(
            n_env, model.joint_dof_count, device=dev),
            nt.batch_state(model.state(), n_env))
        ctl = batched_control(model, torch.zeros(n_env, 0, device=dev))
        rec = {}
        solver.step_batched(state, None, ctl, pipe.collide(state), DT,
                            record=rec)
        (J, *_), kw = rec["pgs"]
        d = J.shape[2]
        shape = (kw["c"], int(kw["ld"].numel()), d)
        if (linalg.kernel_instance(d) != b1_inst
                or pgs.kernel_instance(*shape) != b2_inst):
            raise AssertionError(f"chain {links}: B1 d = {d} takes "
                                 f"{linalg.kernel_instance(d)}, B2 {shape} "
                                 f"takes {pgs.kernel_instance(*shape)}")
        reset_robot_launches()
        s = state
        for _ in range(CHAIN_SUBSTEPS):
            s = solver.step_batched(s, None, ctl, pipe.collide(s), DT)
        torch.cuda.synchronize()
        launches = dict(zip(("chol_inv_solve", "pgs_solve_fused"),
                            kernel_launches()))
        if set(launches.values()) != {CHAIN_SUBSTEPS}:
            raise AssertionError(f"chain {links}: launches {launches} in "
                                 f"{CHAIN_SUBSTEPS} substeps")
        check_state(s, f"chain {links}", z_min=-0.05)
        e_lam, e_dqd, n_diff, _, same = compare_pgs(rec["pgs"][0],
                                                    rec["pgs"][1],
                                                    max(n_env // 1000, 1))
        b1_err, b1_exact = b1_check(*rec["chol"], f"chain {links}")
        k = solver.step_batched(state.clone(), None, ctl,
                                pipe.collide(state), DT)
        p = solver.step_batched(state.clone(), None, ctl,
                                pipe.collide(state), DT, kernels=False)
        errs = {}
        for name, atol in (("joint_q", 2e-4), ("joint_qd", 5e-3),
                           ("body_q", 2e-4)):
            ok, e = close(getattr(k, name)[same], getattr(p, name)[same],
                          atol, atol)
            if not ok:
                raise AssertionError(f"chain {links}: {name} kernel vs "
                                     f"plain off tolerance ({e:.3g})")
            errs[name] = e
        args, kw = rec["pgs"]
        Mi, rhs = rec["chol"]
        out[links] = dict(
            envs=n_env, d=d, b2_shape=shape, b1_instance=b1_inst,
            b2_instance=b2_inst, launches=launches, substeps=CHAIN_SUBSTEPS,
            paths=errs, b1_max_abs_err=b1_err, b1_bit_exact=b1_exact,
            pgs_lam_err=e_lam, pgs_dqd_err=e_dqd, guard_mismatch_envs=n_diff,
            b1=b1_times(Mi, rhs),
            b2_ms=time_ms(lambda: pgs.pgs_solve_fused(*args, **kw),
                          queued=True),
            b2_plain_ms=time_ms(lambda: pgs.pgs_solve_fused_plain(
                *args, **kw), n=5))
    n_env = 1024
    args, ld = random_pgs_inputs(dev, 192, 40, 48, seed=41, n=n_env)
    kw = dict(c=192, ld=ld, iters=ITERS, omega=0.8, use_cone=False,
              diag_scale=1.0, reg=1e-3)
    e1, e2, n_diff, _, _ = compare_pgs(args, kw, n_env // 1000)
    out["random (192, 40, 48)"] = dict(
        envs=n_env, instance=pgs.kernel_instance(192, 40, 48),
        smem_bytes=pgs.smem_bytes(192, 40, 48), lam_err=e1, dqd_err=e2,
        guard_mismatch_envs=n_diff,
        ms=time_ms(lambda: pgs.pgs_solve_fused(*args, **kw), queued=True),
        plain_ms=time_ms(lambda: pgs.pgs_solve_fused_plain(*args, **kw),
                         n=5))
    return out


PLANAR_W = 4096
HOPPER_DT = 0.002                     # hopper.xml's timestep, Hopper-v5
HOPPER_NOISE = 5e-3                   # Hopper-v5's reset_noise_scale
HOPPER_WARMUP = 10
SHIFT_X = 5.0
SHIFT_TOL = {"joint_q": 1e-4, "joint_qd": 1e-3}


def build_cheetah(dev):
    import newton_tpu_torch as nt
    b = nt.ModelBuilder()
    b.add_mjcf(os.path.join(nt.ASSET_DIR, "half_cheetah.xml"))
    model = b.finalize(dev)
    return (model, nt.CollisionPipeline(model),
            nt.SolverMuJoCo(model, iterations=ITERS, integrator="euler"))


def check_torso(state, n, label, torso_z):
    """check_state without the free-joint height, and each of the n envs'
    (or worlds') body 0, the torso, above ``torso_z``."""
    check_state(state, label, z_min=None)
    z = float(state.body_q.view(n, -1, 7)[:, 0, 2].min())
    if z <= torso_z:
        raise AssertionError(f"{label}: torso fell to z = {z:.3f}")
    return z


def phase_cheetah(dev):
    """half_cheetah x 4096 as bench.py --robot half_cheetah runs it
    (step_batched, euler, 8 PGS iterations, dt 1/240, 4 substeps, uniform
    ctrl in [-1, 1]): a warm-up frame then FRAMES checked frames with one
    launch of B1 (d = 9) and B2 (16, 6, 9) per substep; the gates, a kernel
    vs plain substep, translation invariance (the same envs 5 m along x
    agree after 4 substeps), env-steps/s in turns."""
    import torch
    import newton_tpu_torch as nt
    from newton_tpu_torch.solvers.generalized import linalg, pgs
    model, pipe, solver = build_cheetah(dev)
    sample = ctrl_sampler(model, dev, seed=40)
    state0 = nt.batch_state(nt.eval_fk(model, model.joint_q0,
                                       model.joint_qd0, model.state()),
                            PLANAR_W)
    rec = {}
    solver.step_batched(state0, None, batched_control(model,
                                                      sample(PLANAR_W)),
                        pipe.collide(state0), DT, record=rec)
    (J, *_), kw = rec["pgs"]
    shape = (kw["c"], int(kw["ld"].numel()), J.shape[2])
    if (tuple(rec["chol"][0].shape) != (PLANAR_W, 9, 9)
            or shape != (16, 6, 9) or linalg.kernel_instance(9) != "reg16"
            or pgs.kernel_instance(*shape) != "smem128"):
        raise AssertionError(f"half_cheetah: B1 {rec['chol'][0].shape}, B2 "
                             f"{shape}; expected d = 9 (reg16) and "
                             "(16, 6, 9) (smem128)")
    state = run_frames(model, pipe, solver, state0, sample, 1, True)
    touched = torch.zeros(PLANAR_W, dtype=torch.bool, device=dev)
    reset_robot_launches()
    t0 = time.perf_counter()
    state = run_frames(model, pipe, solver, state, sample, FRAMES, True,
                       touched)
    elapsed = time.perf_counter() - t0
    n_sub = FRAMES * SUBSTEPS
    launches = dict(zip(("chol_inv_solve", "pgs_solve_fused"),
                        kernel_launches()))
    if set(launches.values()) != {n_sub}:
        raise AssertionError(f"half_cheetah: launches {launches} in {n_sub} "
                             "substeps")
    zmin = check_torso(state, PLANAR_W, "half_cheetah", 0.0)
    untouched = int((~touched).sum())
    if untouched > PLANAR_W // 100:
        raise AssertionError(f"half_cheetah: {untouched} envs without an "
                             "active contact in the window")
    end_state = state
    paths = phase_paths(model, pipe, solver, {"window end": end_state},
                        ctrl_sampler(model, dev, seed=41))
    shift = cheetah_shift(model, pipe, solver, end_state,
                          ctrl_sampler(model, dev, seed=42))
    plain = run_frames(model, pipe, solver, state0, sample, 1, False)
    rates = {True: [], False: []}
    for kernels in (False, True, True, False):
        before = kernel_launches()
        t0 = time.perf_counter()
        if kernels:
            state = run_frames(model, pipe, solver, state, sample,
                               TURN_FRAMES, True)
        else:
            plain = run_frames(model, pipe, solver, plain, sample,
                               TURN_FRAMES, False)
        rates[kernels].append(TURN_FRAMES * SUBSTEPS * PLANAR_W
                              / (time.perf_counter() - t0))
        if not kernels and kernel_launches() != before:
            raise AssertionError("the half_cheetah plain path launched a "
                                 "kernel")
    check_torso(plain, PLANAR_W, "half_cheetah plain path", 0.0)
    check_torso(state, PLANAR_W, "half_cheetah kernel path", 0.0)
    args, kw = rec["pgs"]
    e_lam, e_dqd, n_diff, _, _ = compare_pgs(args, kw, PLANAR_W // 1000)
    b1_err, b1_exact = b1_check(*rec["chol"], "half_cheetah")
    Mi, rhs = rec["chol"]
    return dict(launches=launches, substeps=n_sub, envs=PLANAR_W,
                torso_z_min=zmin, envs_untouched_in_window=untouched,
                main_env_steps_per_s=n_sub * PLANAR_W / elapsed,
                env_steps_per_s=sum(rates[True]) / 2,
                plain_env_steps_per_s=sum(rates[False]) / 2,
                turns_kernel=rates[True], turns_plain=rates[False],
                paths=paths["window end"], shift=shift, pgs_lam_err=e_lam,
                pgs_dqd_err=e_dqd, guard_mismatch_envs=n_diff,
                b1_max_abs_err=b1_err, b1_bit_exact=b1_exact,
                b1=b1_times(Mi, rhs),
                b2_ms=time_ms(lambda: pgs.pgs_solve_fused(*args, **kw),
                              queued=True),
                b2_plain_ms=time_ms(lambda: pgs.pgs_solve_fused_plain(
                    *args, **kw), n=10))


def cheetah_shift(model, pipe, solver, state, sample, substeps=4):
    """The envs of ``state`` and the same envs moved SHIFT_X along x
    (rootx), stepped ``substeps`` with the same ctrl: joint_q (rootx less
    SHIFT_X) and joint_qd agree within SHIFT_TOL."""
    import newton_tpu_torch as nt
    q = state.joint_q.clone()
    q[:, 0] += SHIFT_X
    moved = nt.eval_fk(model, q, state.joint_qd.clone(), state.clone())
    a, b = state.clone(), moved
    for _ in range(substeps):
        ctl = batched_control(model, sample(PLANAR_W))
        a = solver.step_batched(a, None, ctl, pipe.collide(a), DT)
        b = solver.step_batched(b, None, ctl, pipe.collide(b), DT)
    qb = b.joint_q.clone()
    qb[:, 0] -= SHIFT_X
    errs = {}
    for name, x, y in (("joint_q", a.joint_q, qb),
                       ("joint_qd", a.joint_qd, b.joint_qd)):
        ok, e = close(x, y, SHIFT_TOL[name], 0.0)
        if not ok:
            raise AssertionError(f"half_cheetah: {name} after {substeps} "
                                 f"substeps 5 m along x differs by {e:.3g}")
        errs[name] = e
    return errs


def phase_hopper_worlds(dev):
    """hopper x 8192 through replicate + step, run as gymnasium's
    Hopper-v5: SolverMuJoCo(iterations=8) with the integrator read from the
    asset (RK4), dt 0.002, 4 substeps per frame (its frame_skip), uniform
    +-5e-3 reset noise, ctrl uniform in [-1, 1]; HOPPER_WARMUP warm-up and
    FRAMES checked frames with four B1 launches (d = 6, one per RK4 stage)
    and one B2 launch (14, 3, 6) per substep; the gates, step against
    step_batched of the one-world hopper (1e-6), a kernel vs plain step,
    env-steps/s in turns and the phase's peak device memory."""
    import torch
    import newton_tpu_torch as nt
    from newton_tpu_torch.solvers.generalized import linalg, pgs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model, pipe, solver, setup_s = build_replicated(
        dev, "hopper.xml", WORLDS, ITERS, integrator="auto")
    if solver.integrator != "rk4":
        raise AssertionError(f"hopper: integrator {solver.integrator!r}, "
                             "expected the asset's rk4")
    sample = ctrl_sampler(model, dev, seed=50)
    state = flat_reset(model, dev, seed=51, noise=HOPPER_NOISE)
    state = run_flat_frames(model, pipe, solver, state, sample,
                            HOPPER_WARMUP, True, dt=HOPPER_DT)
    rec = {}
    ctl = model.control()
    ctl.custom["mjc:ctrl"] = sample(1)[0]
    solver.step(state, None, ctl, pipe.collide(state), HOPPER_DT, record=rec)
    (J, *_), kw = rec["pgs"]
    shape = (kw["c"], int(kw["ld"].numel()), J.shape[2])
    if (tuple(rec["chol"][0].shape) != (WORLDS, 6, 6) or shape != (14, 3, 6)
            or linalg.kernel_instance(6) != "reg8"
            or pgs.kernel_instance(*shape) != "smem128"):
        raise AssertionError(f"hopper: B1 {rec['chol'][0].shape}, B2 "
                             f"{shape}; expected d = 6 (reg8) and (14, 3, 6)"
                             f" (smem128) at {WORLDS} worlds")
    reset_robot_launches()
    t0 = time.perf_counter()
    state = run_flat_frames(model, pipe, solver, state, sample, FRAMES, True,
                            dt=HOPPER_DT)
    elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n_sub = FRAMES * SUBSTEPS
    launches = dict(zip(("chol_inv_solve", "pgs_solve_fused"),
                        kernel_launches()))
    if launches != dict(chol_inv_solve=4 * n_sub, pgs_solve_fused=n_sub):
        raise AssertionError(f"hopper: launches {launches} in {n_sub} "
                             "substeps, expected B1 four times (RK4) and B2 "
                             "once per substep")
    zmin = check_torso(state, WORLDS, "hopper", 0.0)
    end_state = state
    plain = state.clone()
    rates, state, plain = flat_turns(model, pipe, solver, state, plain,
                                     sample, WORLDS, dt=HOPPER_DT)
    check_torso(plain, WORLDS, "hopper plain path", 0.0)
    check_torso(state, WORLDS, "hopper kernel path", 0.0)
    args, kw = rec["pgs"]
    e_lam, e_dqd, n_diff, _, _ = compare_pgs(args, kw, WORLDS // 1000)
    errs = flat_paths(model, pipe, solver, end_state, sample, "hopper",
                      dt=HOPPER_DT)
    b1_err, b1_exact = b1_check(*rec["chol"], "hopper")
    one = nt.ModelBuilder()
    one.add_mjcf(os.path.join(nt.ASSET_DIR, "hopper.xml"))
    one = one.finalize(dev)
    agree = step_vs_batched(model, pipe, solver, end_state, sample,
                            (one, nt.CollisionPipeline(one),
                             nt.SolverMuJoCo(one, iterations=ITERS)),
                            dt=HOPPER_DT)
    Mi, rhs = rec["chol"]
    return dict(launches=launches, substeps=n_sub, worlds=WORLDS,
                setup_s=setup_s, torso_z_min=zmin, peak_memory_bytes=peak,
                main_env_steps_per_s=n_sub * WORLDS / elapsed,
                env_steps_per_s=sum(rates[True]) / 2,
                plain_env_steps_per_s=sum(rates[False]) / 2,
                turns_kernel=rates[True], turns_plain=rates[False],
                paths=errs, pgs_lam_err=e_lam, pgs_dqd_err=e_dqd,
                guard_mismatch_rows=n_diff, b1_max_abs_err=b1_err,
                b1_bit_exact=b1_exact, step_vs_batched=agree,
                b1=b1_times(Mi, rhs),
                b2_ms=time_ms(lambda: pgs.pgs_solve_fused(*args, **kw),
                              queued=True),
                b2_plain_ms=time_ms(lambda: pgs.pgs_solve_fused_plain(
                    *args, **kw), n=10))


# ----------------------------------------------------------------------
# heterogeneous worlds and ball joints (phases 18-20): the scenes are
# written against a builder module ``lib`` with the JAX package's API, so
# the CPU tests build the same scenes with both packages
# ----------------------------------------------------------------------
HETERO_W = 4096
SHOWCASE_W = 1024
ROD_DT = 1.0 / 480.0                  # example_rod_swing.py
ROD_SUBSTEPS = 8
ROD_FRAMES = 20                       # 1/3 s; the example's test_final
                                      # runs 1 s (the tip stays in
                                      # 0.92-0.97 throughout)
ROD_TURN_FRAMES = 2                   # frames per turn of the rate turns
ROD_SPACING = 0.1
BALL_RADIUS = 0.2                     # the ant's ball: 0.45 kg, 0.2 m
BALL_MASS = 0.45
# on the diagonal beyond the front-left foot's tip (0.616, 0.616, 0.074 at
# joint_q0), 5 mm into it: the foot and the ball touch at reset
BALL_XY = 0.789
ANT_MASS_SCALE = (0.8, 1.2)
MU_RANGE = (0.5, 1.25)


def rod_scene(lib, n):
    """example_rod_swing.py's rod (8 ball-jointed capsules from (0, 0, 1)
    to (1, 0, 1), radius 0.02, bend_ke 200, bend_kd 3, fixed root)
    replicated to n worlds ROD_SPACING apart in y: each world's root
    joint_X_p differs."""
    r = lib.ModelBuilder()
    bodies = r.add_rod([0.0, 0.0, 1.0], [1.0, 0.0, 1.0], segments=8,
                       radius=0.02, bend_ke=200.0, bend_kd=3.0,
                       root_joint="fixed", key="rod")
    b = lib.ModelBuilder()
    b.replicate(r, n, spacing=(0.0, ROD_SPACING, 0.0))
    return b, bodies[-1]


def ant_ball_scene(lib, n, ant_xml):
    """n worlds of gymnasium's ant and a free 0.45 kg ball of radius 0.2
    on the ground, touching the front-left foot at reset (a robot
    dribbling an object, as OGBench's antsoccer): two articulations per
    world, the ball in its own."""
    r = lib.ModelBuilder()
    r.add_mjcf(ant_xml)
    r.add_articulation()
    cfg = lib.ShapeConfig(density=BALL_MASS / (4.0 / 3.0 * 3.141592653589793
                                               * BALL_RADIUS ** 3))
    ball = r.add_body(xform=[BALL_XY, BALL_XY, BALL_RADIUS, 0, 0, 0, 1],
                      key="ball")
    r.add_shape_sphere(ball, radius=BALL_RADIUS, cfg=cfg, key="ball")
    r.add_joint_free(ball, key="ball")
    b = lib.ModelBuilder()
    b.replicate(r, n)
    return b, r


def showcase_scene(lib, n):
    """example_basic_joints.py's world (revolute, prismatic, ball, fixed,
    free and one-axis D6 articulations side by side, capsule links, no
    ground) replicated n times: six articulation groups, one of them
    without dofs."""
    w = lib.ModelBuilder()
    cfg = lib.ShapeConfig(density=1000.0)

    def link(x, key):
        body = w.add_body(xform=[x, 0, 1.0, 0, 0, 0, 1], key=key)
        w.add_shape_capsule(body, radius=0.05, half_height=0.2, cfg=cfg)
        return body
    hinge = [0, 0, 0.3, 0, 0, 0, 1]
    w.add_joint_revolute(-1, link(0.0, "revolute"), axis="Y",
                         xform_p=[0, 0, 1.3, 0, 0, 0, 1], xform_c=hinge)
    w.add_articulation()
    w.add_joint_prismatic(-1, link(1.0, "prismatic"), axis="X",
                          xform_p=[1.0, 0, 1.0, 0, 0, 0, 1])
    w.add_articulation()
    w.add_joint_ball(-1, link(2.0, "ball"), xform_p=[2.0, 0, 1.3, 0, 0, 0, 1],
                     xform_c=hinge)
    w.add_articulation()
    w.add_joint_fixed(-1, link(3.0, "fixed"),
                      xform_p=[3.0, 0, 1.0, 0, 0, 0, 1])
    w.add_articulation()
    w.add_joint_free(link(4.0, "free"))
    w.add_articulation()
    w.add_joint_d6(-1, link(5.0, "d6"),
                   angular_axes=[lib.JointDofConfig(axis="X")],
                   xform_p=[5.0, 0, 1.3, 0, 0, 0, 1], xform_c=hinge)
    b = lib.ModelBuilder()
    b.replicate(w, n)
    return b


def showcase_kicks(st):
    """The example's kicks in every world, as (dof indices, values): the
    revolute joints at 2 rad/s, the ball joints at (1.5, 1.0, 0) rad/s."""
    import numpy as np
    starts = np.asarray(st.joint_qd_start[:-1])
    jt = np.asarray(st.joint_type)
    rev, ball = starts[jt == 1], starts[jt == 2]
    idx = np.concatenate([rev, ball, ball + 1])
    val = np.concatenate([np.full(len(rev), 2.0), np.full(len(ball), 1.5),
                          np.full(len(ball), 1.0)])
    return idx, val.astype(np.float32)


def ragged_scene(lib, n):
    """example_hetero_worlds.py with its box pedestal a static sphere of
    radius 0.2 at z = 0.2 (the port has no box pair): a free sphere of
    radius 0.3 dropped from z = 1 in every world, the pedestal in the odd
    worlds only, a global ground plane. The odd worlds' rows have one
    contact slot more: a ragged plan."""
    b = lib.ModelBuilder()
    for w in range(n):
        b.begin_world()
        b.add_articulation()
        body = b.add_body(xform=[0, 0, 1.0, 0, 0, 0, 1])
        b.add_shape_sphere(body, radius=0.3)
        b.add_joint_free(body)
        if w % 2:
            b.add_shape_sphere(-1, xform=[0, 0, 0.2, 0, 0, 0, 1],
                               radius=0.2)
        b.end_world()
    b.add_ground_plane()
    return b


PYRAMID_H = 0.15                      # example_pyramid.py's half-extent
DOMINO_N = 10                         # example_domino_spiral.py
DOMINO_H = 0.30


def pyramid_scene(lib, n):
    """example_pyramid.py's world (six free boxes of half-extent 0.15 in
    rows 3-2-1 with 2 mm gaps, mu 0.8, on a ground plane of mu 0.8)
    replicated n times. Returns the builder and the top box's body index
    in a world."""
    w = lib.ModelBuilder()
    cfg = lib.ShapeConfig(mu=0.8)
    h = PYRAMID_H
    top = None
    for r, count in enumerate((3, 2, 1)):
        x0 = -(count - 1) * h
        for i in range(count):
            top = w.add_body(xform=[x0 + i * 2 * h, 0, h + r * 2 * h
                                    + 0.002 * r, 0, 0, 0, 1],
                             key=f"box_{r}_{i}")
            w.add_shape_box(top, hx=h, hy=h, hz=h, cfg=cfg)
            w.add_joint_free(top)
    b = lib.ModelBuilder()
    b.replicate(w, n)
    b.add_ground_plane(cfg=cfg)
    return b, top


def domino_scene(lib, n):
    """example_domino_spiral.py's world (ten free boxes of half-extents
    0.02 x 0.09 x 0.15 standing on a spiral of radius 1 + 0.02 per domino,
    spaced 0.55 domino heights, mu 0.6) replicated n times, with the
    ground plane. Returns the builder and the first domino's initial
    velocity (0, 1.4, 0) (the nudge along the spiral's tangent) as a
    (n * 10, 6) body_qd of every world."""
    import math
    import numpy as np
    w = lib.ModelBuilder()
    cfg = w.default_shape_cfg.copy()
    cfg.mu = 0.6
    theta, r = 0.0, 1.0
    for i in range(DOMINO_N):
        body = w.add_body(xform=[r * math.cos(theta), r * math.sin(theta),
                                 DOMINO_H / 2, 0.0, 0.0, math.sin(theta / 2),
                                 math.cos(theta / 2)], key=f"domino_{i}")
        w.add_shape_box(body, hx=0.02, hy=0.09, hz=DOMINO_H / 2, cfg=cfg,
                        key=f"domino_shape_{i}")
        w.add_joint_free(body, key=f"domino_free_{i}")
        theta += 0.55 * DOMINO_H / r
        r += 0.02
    b = lib.ModelBuilder()
    b.replicate(w, n)
    b.add_ground_plane()
    qd = np.zeros((n, DOMINO_N, 6), dtype=np.float32)
    qd[:, 0, 1] = 1.4
    return b, qd.reshape(-1, 6)


def randomize_ant_ball(model, seed):
    """Per-world domain randomization, from ``seed``: every ant body's
    mass and inertia times one factor U(0.8, 1.2) of its world, every
    shape's mu in U(0.5, 1.25), inverse mass and inertia kept
    consistent. Edits the model's tensors in place (the caller then calls
    ``solver.notify_model_changed()``)."""
    import torch
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    st = model.structure
    n = st.world_count
    nb = st.body_count // n
    ant = torch.tensor([k != "ball" for k in st.body_key[:nb]])
    f = ANT_MASS_SCALE[0] + (ANT_MASS_SCALE[1] - ANT_MASS_SCALE[0]) \
        * torch.rand(n, 1, generator=gen)
    f = torch.where(ant[None], f, 1.0).reshape(-1).to(model.device)
    model.body_mass.mul_(f)
    model.body_inertia.mul_(f[:, None, None])
    model.body_inv_mass.div_(f)
    model.body_inv_inertia.div_(f[:, None, None])
    mu = MU_RANGE[0] + (MU_RANGE[1] - MU_RANGE[0]) * torch.rand(
        st.shape_count, generator=gen)
    model.shape_material_mu.copy_(mu.to(model.device))


def groups_alone(solver, state, ctl, contacts, out, dt):
    """Largest difference between ``step``'s result ``out`` on the flat
    state and each articulation group's rows stepped alone (gathered from
    the same input, one substep, no other group in the call)."""
    import torch
    from newton_tpu_torch.solvers.generalized import batched
    worst = 0.0
    for grp in solver.groups:
        t = grp.tables
        if t.d == 0:
            continue
        rows, c, crows = batched._gather_rows(grp, state, ctl, contacts)
        one = batched._substep(solver, grp, rows, c, crows, dt, True, None)
        for name, idx in (("joint_q", t.row_coord), ("joint_qd", t.row_dof),
                          ("body_q", t.row_body), ("body_qd", t.row_body)):
            mine = getattr(one, name)
            if name.startswith("body_"):
                mine = mine[:, :t.nb]       # not a mounted row's mounts
            worst = max(worst, float((getattr(out, name)[idx]
                                      - mine).abs().max()))
    torch.cuda.synchronize()
    if worst > STEP_VS_BATCHED_TOL:
        raise AssertionError(f"step vs its groups stepped alone: {worst} > "
                             f"{STEP_VS_BATCHED_TOL}")
    return worst


def run_steps(solver, state, ctl, substeps, dt, kernels, pipe=None,
              sample=None, touched=None):
    """``substeps`` flat ``step`` calls, collide each substep when a
    pipeline is given, a new mjc:ctrl every SUBSTEPS substeps when a
    sampler is; ``touched`` (slots, worlds) gathers which worlds had one of
    the given slots active."""
    import torch
    for k in range(substeps):
        if sample is not None and k % SUBSTEPS == 0:
            ctl.custom["mjc:ctrl"] = sample(1)[0]
        contacts = None if pipe is None else pipe.collide(state)
        if touched is not None:
            slots, seen = touched
            seen |= contacts.rigid_contact_mask[slots].any(1)
        state = solver.step(state, None, ctl, contacts, dt, kernels=kernels)
    torch.cuda.synchronize()
    return state


def turns(solver, state, plain, ctl, substeps, n, dt, **kw):
    """env-steps/s of the kernel and plain paths in turns (plain, kernel,
    kernel, plain), each turn continuing its own state; the plain turns
    launch no kernel."""
    rates = {True: [], False: []}
    for kernels in (False, True, True, False):
        before = kernel_launches()
        t0 = time.perf_counter()
        if kernels:
            state = run_steps(solver, state, ctl, substeps, dt, True, **kw)
        else:
            plain = run_steps(solver, plain, ctl, substeps, dt, False, **kw)
        rates[kernels].append(substeps * n / (time.perf_counter() - t0))
        if not kernels and kernel_launches() != before:
            raise AssertionError("a plain path launched a kernel")
    return rates, state, plain


def group_paths(solver, state, ctl, contacts, dt, label):
    """One ``step`` through the kernels and one through the plain versions
    from one state: each group's B1 held against its plain version on its
    operands (atol 1e-5, rtol 1e-4) and B2 likewise (phase 6's
    tolerances; rows whose guard halvings differ are counted and left out,
    at most N / 100 of them: a halving is a threshold decision on
    ||dlambda||^2 that the kernel's sum order can tip, more often where a
    two-sided row's w_other dominates its diagonal); the states agree
    (joint_q/body_q 2e-4, joint_qd 5e-3). Returns the errors and each
    group's record."""
    rec = {}
    k = solver.step(state.clone(), None, ctl, contacts, dt, record=rec)
    p = solver.step(state.clone(), None, ctl, contacts, dt, kernels=False)
    recs = rec.get("groups", {0: rec})
    errs, rows_ok = {}, None
    for gi, r in recs.items():
        n = r["chol"][0].shape[0]
        errs[f"b1 group {gi}"] = b1_check(*r["chol"], f"{label} group {gi}")
        if "pgs" in r:
            e_lam, e_dqd, n_diff, _, ok = compare_pgs(*r["pgs"],
                                                      max(n // 100, 1))
            errs[f"b2 group {gi}"] = dict(lam=e_lam, dqd=e_dqd,
                                          guard_mismatch_rows=n_diff)
            rows_ok = ok if rows_ok is None else rows_ok & ok
    for name, atol in (("joint_q", 2e-4), ("joint_qd", 5e-3),
                       ("body_q", 2e-4)):
        n = len(rows_ok) if rows_ok is not None else 1
        a = getattr(k, name).view(n, -1)
        b = getattr(p, name).view(n, -1)
        if rows_ok is not None:
            a, b = a[rows_ok], b[rows_ok]
        ok, e = close(a, b, atol, atol)
        if not ok:
            raise AssertionError(f"{label}: {name} kernel vs plain step "
                                 f"off tolerance ({e:.3g})")
        errs[name] = e
    return errs, recs


def phase_rod(dev):
    """rod x 4096 (example_rod_swing.py, ROD_SPACING apart): 1/3 s of
    SolverFeatherstone.step at dt 1/480, 8 substeps per frame, no contacts
    (as the example): one B1 launch (d = 21) per substep and no B2; finite
    state, unit ball quaternions, every tip z in (0.6, 1.01] (the
    example's test_final), world k's tip world 0's moved by its offset
    (1e-4); step against its group stepped alone (1e-6), a kernel vs plain
    step, env-steps/s in turns, setup time and peak device memory."""
    import numpy as np
    import torch
    import newton_tpu_torch as nt
    from newton_tpu_torch.solvers.generalized import linalg
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    b, tip = rod_scene(nt, HETERO_W)
    offsets = np.asarray(b.joint_X_p)[0::8, 1]            # root y per world
    model = b.finalize(dev)
    solver = nt.SolverFeatherstone(model)
    setup_s = time.perf_counter() - t0
    if [(g.g.n, g.g.d) for g in solver.groups] != [(HETERO_W, 21)] \
            or linalg.kernel_instance(21) != "reg24":
        raise AssertionError("rod: expected one group of d = 21 (reg24)")
    state = nt.eval_fk(model, model.joint_q0, model.joint_qd0, model.state())
    ctl = model.control()
    n_sub = ROD_FRAMES * ROD_SUBSTEPS
    reset_robot_launches()
    t0 = time.perf_counter()
    state = run_steps(solver, state, ctl, n_sub, ROD_DT, True)
    elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = dict(zip(("chol_inv_solve", "pgs_solve_fused"),
                        kernel_launches()))
    if launches != dict(chol_inv_solve=n_sub, pgs_solve_fused=0):
        raise AssertionError(f"rod: launches {launches} in {n_sub} substeps")
    check_state(state, "rod", None)
    quat = state.joint_q.view(HETERO_W, -1).view(HETERO_W, 7, 4)
    if float((torch.linalg.vector_norm(quat, dim=-1) - 1).abs().max()) > 1e-2:
        raise AssertionError("rod: ball quaternions off unit length")
    bq = state.body_q.view(HETERO_W, 8, 7)[:, tip]
    tip_z = bq[:, 2]
    if not bool(((tip_z > 0.6) & (tip_z <= 1.01)).all()):
        raise AssertionError(f"rod: tip z in [{float(tip_z.min()):.3f}, "
                             f"{float(tip_z.max()):.3f}], not (0.6, 1.01]")
    off = torch.zeros_like(bq[:, :3])
    off[:, 1] = torch.as_tensor(offsets - offsets[0], dtype=off.dtype,
                                device=dev)
    shift = float((bq[:, :3] - bq[:1, :3] - off).abs().max())
    if shift > 1e-4:
        raise AssertionError(f"rod: world tips differ from world 0's moved "
                             f"by their offsets by {shift:.3g}")
    errs, recs = group_paths(solver, state, ctl, None, ROD_DT, "rod")
    out = solver.step(state, None, ctl, None, ROD_DT)
    alone = groups_alone(solver, state, ctl, None, out, ROD_DT)
    rates, state, plain = turns(solver, state, state.clone(), ctl,
                                ROD_TURN_FRAMES * ROD_SUBSTEPS, HETERO_W,
                                ROD_DT)
    check_state(state, "rod kernel path", None)
    check_state(plain, "rod plain path", None)
    Mi, rhs = recs[0]["chol"]
    return dict(launches=launches, substeps=n_sub, worlds=HETERO_W,
                setup_s=setup_s, peak_memory_bytes=peak,
                tip_z=[float(tip_z.min()), float(tip_z.max())],
                tip_shift_err=shift,
                main_env_steps_per_s=n_sub * HETERO_W / elapsed,
                env_steps_per_s=sum(rates[True]) / 2,
                plain_env_steps_per_s=sum(rates[False]) / 2,
                turns_kernel=rates[True], turns_plain=rates[False],
                paths=errs, groups_alone=alone,
                b1_max_abs_err=errs["b1 group 0"][0],
                b1_bit_exact=errs["b1 group 0"][1], b1=b1_times(Mi, rhs))


def ant_ball_halves(solver, rec, contacts):
    """The two halves of every active ant-ball contact: the ant cell's
    and the ball cell's normal impulses on the same slot (the ball cell's
    two-sided entries, found in the ant cell's plan; a compacted entry
    that was not kept counts as 0). Returns (pairs with an impulse, the
    median and the largest |a - b| / max(a, b), both halves finite and
    >= 0)."""
    import numpy as np
    import torch
    ga, gb = solver.groups
    halves = []
    for grp in (ga, gb):
        r = rec["groups"][grp.index]
        (J, *_), kw = r["pgs"]
        c = kw["c"]
        lam = r["lam"][:, :c]                              # (n, K) normal
        full = torch.zeros((lam.shape[0], grp.plan.c), device=lam.device)
        idx = grp.tables.cap < grp.plan.c
        # the compacted entries back onto the plan's slots: compaction
        # picks the top-K scores, recomputed here as the step did
        if idx:
            act = contacts.rigid_contact_mask[grp.tables.row_slots]
            if grp.tables.valid is not None:
                act = act & grp.tables.valid
            depth = contacts.rigid_contact_depth[grp.tables.row_slots]
            from newton_tpu_torch.solvers.generalized.batched import \
                compaction_indices
            sel = compaction_indices(act.float() * torch.clamp(
                1.0 + depth, min=0.5), grp.tables.cap)
            full.scatter_(1, sel, lam)
        else:
            full = lam
        halves.append(full)
    ob = gb.plan.ob
    pos = np.nonzero(ob >= 0)
    slots = gb.plan.slots[pos]
    a_slots = ga.plan.slots
    j_a = np.argmax(a_slots[pos[0]] == slots[:, None], axis=1)
    e = torch.as_tensor(pos[0], device=halves[0].device)
    ha = halves[0][e, torch.as_tensor(j_a, device=e.device)]
    hb = halves[1][e, torch.as_tensor(pos[1], device=e.device)]
    act = contacts.rigid_contact_mask[torch.as_tensor(slots,
                                                      device=e.device)]
    on = act & ((ha > 0) | (hb > 0))
    ok = bool(torch.isfinite(ha).all() and torch.isfinite(hb).all()
              and (ha >= 0).all() and (hb >= 0).all())
    rel = ((ha - hb).abs() / torch.maximum(ha, hb).clamp(min=1e-30))[on]
    if not rel.numel():
        return 0, 0.0, 0.0, ok
    return int(on.sum()), float(rel.median()), float(rel.max()), ok


def phase_ant_ball(dev):
    """ant with a ball x 4096, domain-randomized per world from a seed
    (ant masses and inertias x U(0.8, 1.2), every shape's mu in U(0.5,
    1.25), applied after the solver is built, then notify_model_changed):
    SolverMuJoCo(iterations=8, euler) through step, dt 1/240, 4 substeps
    per frame, uniform ctrl; a warm-up frame then FRAMES frames with one
    B1 and one B2 launch per group (ant d = 14, ball d = 6) per substep,
    B2 of both groups with w_other; phase 5's ant gates, an active
    ant-ball contact in >= 50% of worlds during the window, ball speed
    finite and < 20 m/s; the two halves of the active ant-ball contacts
    (reported); step against its groups stepped alone (1e-6); a kernel vs
    plain step; env-steps/s in turns, setup time, peak device memory."""
    import torch
    import newton_tpu_torch as nt
    import dataclasses
    from newton_tpu_torch.solvers.generalized import linalg, pgs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n = HETERO_W
    t0 = time.perf_counter()
    b, _ = ant_ball_scene(nt, n, os.path.join(nt.ASSET_DIR, "ant.xml"))
    model = b.finalize(dev)
    pipe = nt.CollisionPipeline(model)
    solver = nt.SolverMuJoCo(model, iterations=ITERS, integrator="euler")
    randomize_ant_ball(model, 60)
    solver.notify_model_changed()
    setup_s = time.perf_counter() - t0
    ga, gb = solver.groups
    if (ga.g.d, gb.g.d) != (14, 6) or ga.tables.other is None \
            or gb.tables.other is None:
        raise AssertionError("ant with ball: expected the ant (d = 14) and "
                             "the ball (d = 6), both with two-sided entries")
    if ga.row_model.body_mass.dim() != 2 or ga.tables.mu.dim() != 2:
        raise AssertionError("ant with ball: the randomized constants did "
                             "not reach per-row tables")
    ball_slots = torch.as_tensor(gb.plan.slots[:, gb.plan.ob[0] >= 0],
                                 device=dev)               # (n, 13)
    sample = ctrl_sampler(model, dev, seed=61)
    state = nt.eval_fk(model, model.joint_q0, model.joint_qd0, model.state())
    plain = state.clone()
    ctl = model.control()
    state = run_steps(solver, state, ctl, SUBSTEPS, DT, True, pipe=pipe,
                      sample=sample)
    touched = torch.zeros(n, dtype=torch.bool, device=dev)
    n_sub = FRAMES * SUBSTEPS
    reset_robot_launches()
    t0 = time.perf_counter()
    state = run_steps(solver, state, ctl, n_sub, DT, True, pipe=pipe,
                      sample=sample, touched=(ball_slots, touched))
    elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = dict(zip(("chol_inv_solve", "pgs_solve_fused"),
                        kernel_launches()))
    if launches != dict(chol_inv_solve=2 * n_sub, pgs_solve_fused=2 * n_sub):
        raise AssertionError(f"ant with ball: launches {launches} in {n_sub}"
                             " substeps, expected B1 and B2 once per group")
    q = state.joint_q.view(n, 22)
    zmin = check_state(dataclasses.replace(state, joint_q=q), "ant with ball")
    in_touch = int(touched.sum())
    if in_touch < n // 2:
        raise AssertionError(f"ant with ball: {in_touch} of {n} worlds with "
                             "an active ant-ball contact in the window")
    v_ball = torch.linalg.vector_norm(state.joint_qd.view(n, 20)[:, 14:17],
                                      dim=1)
    if not bool(torch.isfinite(v_ball).all()) or float(v_ball.max()) >= 20:
        raise AssertionError(f"ant with ball: ball speed "
                             f"{float(v_ball.max()):.3g} m/s")
    ctl.custom["mjc:ctrl"] = sample(1)[0]
    contacts = pipe.collide(state)
    errs, recs = group_paths(solver, state, ctl, contacts, DT,
                             "ant with ball")
    rec = {"groups": recs}
    pairs, rel_med, rel_max, halves_ok = ant_ball_halves(solver, rec,
                                                         contacts)
    if not halves_ok:
        raise AssertionError("ant with ball: a contact half is negative or "
                             "not finite")
    out = solver.step(state, None, ctl, contacts, DT)
    alone = groups_alone(solver, state, ctl, contacts, out, DT)
    end_state = state
    plain = run_steps(solver, plain, ctl, SUBSTEPS, DT, False, pipe=pipe,
                      sample=sample)
    rates, state, plain = turns(solver, state, plain, ctl,
                                TURN_FRAMES * SUBSTEPS, n, DT, pipe=pipe,
                                sample=sample)
    for st_, label in ((state, "kernel"), (plain, "plain")):
        check_state(dataclasses.replace(st_, joint_q=st_.joint_q.view(n, 22)),
                    f"ant with ball {label} path", 0.05)
    times = {}
    for gi, r in recs.items():
        args, kw = r["pgs"]
        Mi, rhs = r["chol"]
        J = args[0]
        times[gi] = dict(
            d=Mi.shape[1], b1_instance=linalg.kernel_instance(Mi.shape[1]),
            b1=b1_times(Mi, rhs),
            b2_shape=(kw["c"], int(kw["ld"].numel()), J.shape[2]),
            b2_instance=pgs.kernel_instance(kw["c"], int(kw["ld"].numel()),
                                            J.shape[2]),
            b2_ms=time_ms(lambda: pgs.pgs_solve_fused(*args, **kw),
                          queued=True),
            b2_plain_ms=time_ms(lambda: pgs.pgs_solve_fused_plain(
                *args, **kw), n=10),
            b2_w_other_max=float(kw["w_other"].max()))
    return dict(launches=launches, substeps=n_sub, worlds=n,
                setup_s=setup_s, peak_memory_bytes=peak, root_z_min=zmin,
                worlds_touching_ball=in_touch,
                ball_speed_max=float(v_ball.max()),
                halves=dict(pairs=pairs, median_rel_diff=rel_med,
                            max_rel_diff=rel_max),
                main_env_steps_per_s=n_sub * n / elapsed,
                env_steps_per_s=sum(rates[True]) / 2,
                plain_env_steps_per_s=sum(rates[False]) / 2,
                turns_kernel=rates[True], turns_plain=rates[False],
                paths=errs, groups_alone=alone, times=times,
                end_root_z=float(end_state.joint_q.view(n, 22)[:, 2].min()))


def phase_showcase_ragged(dev):
    """Not user configurations, at SHOWCASE_W worlds. (a) The joint
    showcase (six articulation groups, d = 1, 1, 3, 0, 6, 1) with the
    example's kicks: 0.5 s of step at dt 1/240, no contacts, one B1 launch
    per group with dofs per substep and no B2; the example's gates in
    every world; a kernel vs plain step (each group's B1 against its plain
    version) and step against its groups alone. (b) The ragged pedestal
    scene: 1.25 s of step with contacts, one B1 and one B2 launch per
    substep (a ragged plan, pad entries masked); spheres at z = 0.3 on the
    ground and 0.7 on the pedestal (+-0.05); a kernel vs plain step (B2
    held against its plain version) and step against its group alone."""
    import torch
    import newton_tpu_torch as nt
    from newton_tpu_torch.math import quat_rotate
    n = SHOWCASE_W
    out = {}
    model = showcase_scene(nt, n).finalize(dev)
    solver = nt.SolverFeatherstone(model)
    dofs = sorted(g.g.d for g in solver.groups)
    if dofs != [0, 1, 1, 1, 3, 6]:
        raise AssertionError(f"showcase: groups of d = {dofs}")
    idx, val = showcase_kicks(model.structure)
    qd = model.joint_qd0.clone()
    qd[torch.as_tensor(idx, device=dev)] = torch.as_tensor(val, device=dev)
    state = nt.eval_fk(model, model.joint_q0, qd, model.state())
    p0 = state.body_q[:, :3].view(n, 6, 3).clone()
    ctl = model.control()
    n_sub = 120
    reset_robot_launches()
    state = run_steps(solver, state, ctl, n_sub, DT, True)
    launches = dict(zip(("chol_inv_solve", "pgs_solve_fused"),
                        kernel_launches()))
    if launches != dict(chol_inv_solve=5 * n_sub, pgs_solve_fused=0):
        raise AssertionError(f"showcase: launches {launches} in {n_sub} "
                             "substeps, expected B1 once per group with dofs")
    check_state(state, "showcase", None)
    p = state.body_q[:, :3].view(n, 6, 3)
    bq = state.body_q.view(n, 6, 7)[:, 2]
    tip = bq[:, :3] + quat_rotate(bq[:, 3:], torch.tensor(
        [0.0, 0.0, 0.3], device=dev))
    anchor = torch.tensor([2.0, 0.0, 1.3], device=dev)
    gates = dict(
        revolute_plane=float((p[:, 0, 1] - p0[:, 0, 1]).abs().max()),
        revolute_moved=float((p[:, 0, 2] - p0[:, 0, 2]).abs().min()),
        prismatic_locked=float((p[:, 1, 1:] - p0[:, 1, 1:]).abs().max()),
        fixed_moved=float((p[:, 3] - p0[:, 3]).norm(dim=-1).max()),
        free_fell=float((p0[:, 4, 2] - p[:, 4, 2]).min()),
        ball_pivot=float((tip - anchor).norm(dim=-1).max()))
    if not (gates["revolute_plane"] < 1e-3 and gates["revolute_moved"] > 1e-3
            and gates["prismatic_locked"] < 1e-3
            and gates["fixed_moved"] < 1e-4 and gates["free_fell"] > 0.05
            and gates["ball_pivot"] < 2e-3):
        raise AssertionError(f"showcase: gates {gates}")
    errs, _ = group_paths(solver, state, ctl, None, DT, "showcase")
    alone = groups_alone(solver, state, ctl, None,
                         solver.step(state, None, ctl, None, DT), DT)
    out["showcase"] = dict(launches=launches, substeps=n_sub, worlds=n,
                           gates=gates, paths=errs, groups_alone=alone)

    model = ragged_scene(nt, n).finalize(dev)
    pipe = nt.CollisionPipeline(model)
    solver = nt.SolverFeatherstone(model, contact_iterations=8)
    plan = solver.contact_plans[0]
    if plan.uniform or plan.valid is None:
        raise AssertionError("ragged: expected a padded plan")
    state = nt.eval_fk(model, model.joint_q0, model.joint_qd0, model.state())
    ctl = model.control()
    n_sub = 300
    reset_robot_launches()
    state = run_steps(solver, state, ctl, n_sub, DT, True, pipe=pipe)
    launches = dict(zip(("chol_inv_solve", "pgs_solve_fused"),
                        kernel_launches()))
    if launches != dict(chol_inv_solve=n_sub, pgs_solve_fused=n_sub):
        raise AssertionError(f"ragged: launches {launches} in {n_sub} "
                             "substeps")
    check_state(state, "ragged", None)
    z = state.body_q[:, 2]
    want = torch.where(torch.arange(n, device=dev) % 2 == 1, 0.7, 0.3)
    z_err = float((z - want).abs().max())
    if z_err > 0.05:
        raise AssertionError(f"ragged: sphere z off by {z_err:.3f}")
    contacts = pipe.collide(state)
    errs, recs = group_paths(solver, state, ctl, contacts, DT, "ragged")
    alone = groups_alone(solver, state, ctl, contacts,
                         solver.step(state, None, ctl, contacts, DT), DT)
    args, kw = recs[0]["pgs"]
    from newton_tpu_torch.solvers.generalized import pgs
    shape = (kw["c"], int(kw["ld"].numel()), args[0].shape[2])
    out["ragged"] = dict(
        launches=launches, substeps=n_sub, worlds=n, z_err=z_err,
        paths=errs, groups_alone=alone, b2_shape=shape,
        b2_instance=pgs.kernel_instance(*shape),
        pad_entries=int((~plan.valid).sum()),
        b2_ms=time_ms(lambda: pgs.pgs_solve_fused(*args, **kw),
                      queued=True),
        b2_plain_ms=time_ms(lambda: pgs.pgs_solve_fused_plain(*args, **kw),
                            n=10))
    return out


XPBD_W = 4096                         # bench.py --solver xpbd's worlds
XPBD_ITERS = 8
XPBD_WARMUP = 10
XPBD_FRAMES = 10                      # bench.py times 50
XPBD_CPU_WORLDS = 8
REPEAT_FIELDS_RIGID = ("body_q", "body_qd", "joint_q", "joint_qd")
BOX_W = 1024
PYRAMID_FRAMES = 40                   # tests/test_examples.py
DOMINO_FRAMES = 110                   # tests/test_examples.py
# eager frames behind the env-steps/s of a path whose gate window is
# replayed from a CUDA graph (phases 23, 45, 50)
RATE_FRAMES = 2


def profile_frame(fn, substeps):
    """``fn`` (``substeps`` substeps: a frame, or one substep) under
    torch.profiler, recording the device's activity only: the device's
    busy share of the window's wall time (the kernels of one stream do not
    overlap; the profiler's own host cost lengthens the window), device
    ops per substep, the device-to-host and host-to-device copies, and the
    device time of the ten largest kernels by name (ms in the window).
    None where the profiler records no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    # host-side operator events are not read; recording them would multiply
    # the events the profiler must collect and hand back
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the profiler's raw events: ``prof.events()`` would build a Python
    # object for each of the ~150,000 host and device events of a heavy
    # frame, ~10 s a frame, outside any timed window but inside the run
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
    if not kernels:
        return None
    by_name = {}
    for e in kernels:
        name = e.name()[:80]        # templated names, cut to their head
        us = e.duration_ns() * 1e-3 if hasattr(e, "duration_ns") \
            else e.duration_us()
        by_name[name] = by_name.get(name, 0.0) + us
    busy = sum(by_name.values()) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(substeps=substeps, wall_ms=wall * 1e3,
                device_busy_ms=busy * 1e3,
                busy_share=busy / wall, device_ops=len(kernels),
                device_ops_per_substep=len(kernels) / substeps,
                memcpy_dtoh=sum("DtoH" in e.name() for e in kernels),
                memcpy_htod=sum("HtoD" in e.name() for e in kernels),
                top_kernels_ms={k: v * 1e-3 for k, v in top})


def busy_unprofiled(prof, worlds, env_steps_per_s):
    """The profiled window's device time over the wall time of its
    substeps unprofiled (the profiler's host cost lengthens the window it
    records)."""
    if prof is None:
        return None
    return prof["device_busy_ms"] / (1e3 * prof["substeps"] * worlds
                                     / env_steps_per_s)


def ant_xpbd_ctrl(model, gen):
    """bench.py --solver xpbd's direct actuation for one frame: joint_f =
    ctrl * mjc:actuator_gear, ctrl uniform in the ctrl range clipped to
    [-1, 1], drawn from ``gen``."""
    import torch
    gear = model.custom["mjc:actuator_gear"]
    lo = torch.clamp(model.custom["mjc:actuator_ctrlrange_lo"], -1.0, 0.0)
    hi = torch.clamp(model.custom["mjc:actuator_ctrlrange_hi"], 0.0, 1.0)
    u = torch.rand(gear.shape[0], generator=gen, device=gen.device)
    return (lo + u * (hi - lo)) * gear


def xpbd_frames(solver, pipe, state, ctl, frames, model=None, gen=None):
    """``frames`` frames of SUBSTEPS XPBD substeps (collide each substep);
    with a generator, a new direct ctrl each frame."""
    import torch
    for _ in range(frames):
        if gen is not None:
            ctl.joint_f = ant_xpbd_ctrl(model, gen)
        for _ in range(SUBSTEPS):
            state = solver.step(state, None, ctl, pipe.collide(state), DT)
    torch.cuda.synchronize()
    return state


def world_slice(state, n, nb, nq, nd):
    """The first n worlds of a flat State of worlds with nb bodies, nq
    coordinates and nd dofs."""
    from dataclasses import replace
    return replace(state, body_q=state.body_q[:n * nb].clone(),
                   body_qd=state.body_qd[:n * nb].clone(),
                   body_f=state.body_f[:n * nb].clone(),
                   joint_q=state.joint_q[:n * nq].clone(),
                   joint_qd=state.joint_qd[:n * nd].clone())


def phase_ant_xpbd(dev):
    """ant x 4096 under SolverXPBD (bench.py --solver xpbd: replicate,
    the static pipeline, iterations 8, dt 1/240, 4 substeps per frame,
    direct ctrl x gear each frame from a seeded generator): 10 warm-up
    and 10 timed frames; bench.py's gates (no NaN in joint_q/body_q, unit
    quaternions to 1e-2), root z > 0 in every world and > 0.1 in 99% of
    them (the JAX package's XPBD ant also sinks below 0.1 in a few
    worlds: ROADMAP C.13); no B1/B2 launch (no TPU kernel lies on the
    XPBD path); 8 worlds stepped 4 substeps on the card equal the port on
    the CPU (body_q 2e-4, joint_qd 5e-3; a world whose contact set
    differs between the two is counted and left out, at most one); two
    runs of one substep on the card equal bit for bit (every sum in a
    fixed order); one profiled substep; env-steps/s, setup
    seconds, peak device memory."""
    import torch
    import newton_tpu_torch as nt
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    robot = nt.ModelBuilder()
    robot.add_mjcf(os.path.join(HERE, "newton_tpu_torch", "assets",
                                "ant.xml"))
    b = nt.ModelBuilder()
    b.replicate(robot, XPBD_W)
    model = b.finalize(dev)
    pipe = nt.CollisionPipeline(model)
    solver = nt.SolverXPBD(model, iterations=XPBD_ITERS)
    state = nt.eval_fk(model, model.joint_q0, model.joint_qd0, model.state())
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    nb, nq, nd = (robot.body_count, robot.joint_coord_count,
                  robot.joint_dof_count)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    ctl = model.control()
    reset_robot_launches()
    state = xpbd_frames(solver, pipe, state, ctl, XPBD_WARMUP, model, gen)
    t0 = time.perf_counter()
    state = xpbd_frames(solver, pipe, state, ctl, XPBD_FRAMES, model, gen)
    elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if kernel_launches() != (0, 0):
        raise AssertionError("ant xpbd: a B1/B2 kernel launched on the XPBD "
                             "path")
    check_state(state, "ant xpbd", None)
    # the JAX package's own XPBD ant sinks its torso (a sphere of radius
    # 0.25) below z = 0.1 in a few worlds under this ctrl (ROADMAP C.13,
    # tools/xpbd_ant_depth.py): every torso above the ground, 99% above 0.1
    root_z = state.joint_q.view(XPBD_W, nq)[:, 2]
    low = int((root_z <= 0.1).sum())
    if not bool((root_z > 0.0).all()) or low > XPBD_W // 100:
        raise AssertionError(f"ant xpbd: root z min {float(root_z.min()):.3f}"
                             f", {low} worlds at or below 0.1")
    # 8 worlds on the card against the port on the CPU
    small = nt.ModelBuilder()
    small.replicate(robot, XPBD_CPU_WORLDS)
    m_d, m_c = small.finalize(dev), small.finalize("cpu")
    s_d = world_slice(state, XPBD_CPU_WORLDS, nb, nq, nd)
    s_c = s_d.to("cpu")
    c_d, c_c = m_d.control(), m_c.control()
    c_d.joint_f = ctl.joint_f[:XPBD_CPU_WORLDS * nd].clone()
    c_c.joint_f = c_d.joint_f.cpu()
    p_d, p_c = nt.CollisionPipeline(m_d), nt.CollisionPipeline(m_c)
    x_d = nt.SolverXPBD(m_d, iterations=XPBD_ITERS)
    x_c = nt.SolverXPBD(m_c, iterations=XPBD_ITERS)
    # a world whose contact set differs between the two (a slot within
    # rounding of the margin) takes a different discrete path: counted
    # and left out, at most one
    flipped = torch.zeros(XPBD_CPU_WORLDS, dtype=torch.bool)
    for _ in range(SUBSTEPS):
        k_d, k_c = p_d.collide(s_d), p_c.collide(s_c)
        flipped |= (k_d.rigid_contact_mask.cpu() != k_c.rigid_contact_mask
                    ).view(XPBD_CPU_WORLDS, -1).any(1)
        s_d = x_d.step(s_d, None, c_d, k_d, DT)
        s_c = x_c.step(s_c, None, c_c, k_c, DT)
    if int(flipped.sum()) > 1:
        raise AssertionError(f"ant xpbd: {int(flipped.sum())} of "
                             f"{XPBD_CPU_WORLDS} worlds changed their contact "
                             "set between the card and the CPU")
    vs_cpu = {"worlds_left_out": int(flipped.sum())}
    for name, atol, per in (("body_q", 2e-4, nb), ("joint_qd", 5e-3, nd)):
        a = getattr(s_d, name).cpu().view(XPBD_CPU_WORLDS, per, -1)
        b_ = getattr(s_c, name).view(XPBD_CPU_WORLDS, per, -1)
        ok, e = close(a[~flipped], b_[~flipped], atol, atol)
        if not ok:
            raise AssertionError(f"ant xpbd: {name} card vs CPU off "
                                 f"tolerance ({e:.3g})")
        vs_cpu[name] = e
    # two runs of one substep on the card
    contacts = pipe.collide(state)
    a = solver.step(state, None, ctl, contacts, DT)
    b2 = solver.step(state, None, ctl, contacts, DT)
    repeat = {n: float((getattr(a, n) - getattr(b2, n)).abs().max())
              for n in REPEAT_FIELDS_RIGID}
    for n in REPEAT_FIELDS_RIGID:
        if not torch.equal(getattr(a, n), getattr(b2, n)):
            raise AssertionError(f"ant xpbd: two runs of a substep differ "
                                 f"in {n} by {repeat[n]:.3g}")
    prof = profile_frame(lambda: solver.step(state, None, ctl,
                                             pipe.collide(state), DT), 1)
    n_sub = XPBD_FRAMES * SUBSTEPS
    rate = n_sub * XPBD_W / elapsed
    return dict(worlds=XPBD_W, setup_s=setup_s, substeps=n_sub,
                env_steps_per_s=rate,
                busy_share_unprofiled=busy_unprofiled(prof, XPBD_W, rate),
                peak_memory_bytes=peak,
                root_z_min=float(root_z.min()), worlds_root_z_below_0_1=low,
                vs_cpu=vs_cpu,
                repeat_max_diff=repeat, profile=prof)


def phase_pyramid(dev):
    """example_pyramid.py x 1024 on SolverFeatherstone(contact_iterations=
    16): one articulation group (d = 36) whose 288 box contact entries per
    world are compacted to 32; 40 frames of 4 substeps with one B1
    (generic_smem) and one B2 ((32, 0, 36)) launch per substep and the
    example's gates in every world; a kernel vs plain step (B1 and B2 held
    against their plain versions on the step's operands, phase 6's
    tolerances and guard-mismatch count); one substep with contact_cap=0
    (all 288 entries: B2's global-scratch instance at (288, 0, 36)) held
    likewise; env-steps/s in turns, times of both kernels."""
    import torch
    import newton_tpu_torch as nt
    from newton_tpu_torch.solvers.generalized import linalg, pgs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    b, top = pyramid_scene(nt, BOX_W)
    model = b.finalize(dev)
    pipe = nt.CollisionPipeline(model)
    solver = nt.SolverFeatherstone(model, contact_iterations=16)
    state0 = nt.eval_fk(model, model.joint_q0, model.joint_qd0,
                        model.state())
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    grp = solver.groups[0]
    if [(g.g.n, g.g.d) for g in solver.groups] != [(BOX_W, 36)] \
            or grp.plan.c != 288 or grp.tables.cap != 32 \
            or grp.tables.other is not None:
        raise AssertionError("pyramid: expected one group of d = 36 with 288 "
                             "one-sided entries compacted to 32")
    b1_inst, b2_inst = linalg.kernel_instance(36), pgs.kernel_instance(32, 0,
                                                                       36)
    ctl = model.control()
    n_sub = PYRAMID_FRAMES * SUBSTEPS
    reset_robot_launches()
    t0 = time.perf_counter()
    state = run_steps(solver, state0, ctl, n_sub, DT, True, pipe=pipe)
    elapsed = time.perf_counter() - t0
    launches = dict(zip(("chol_inv_solve", "pgs_solve_fused"),
                        kernel_launches()))
    if launches != dict(chol_inv_solve=n_sub, pgs_solve_fused=n_sub):
        raise AssertionError(f"pyramid: launches {launches} in {n_sub} "
                             "substeps")
    check_state(state, "pyramid", None)
    pos = state.body_q[:, :3].view(BOX_W, 6, 3)
    top_p = pos[:, top]
    gates = dict(top_z_min=float(top_p[:, 2].min()),
                 top_xy_max=float(top_p[:, :2].abs().max()),
                 box_xy_max=float(pos[..., :2].abs().max()))
    if not (gates["top_z_min"] > 0.6 and gates["top_xy_max"] < 0.1
            and gates["box_xy_max"] < 0.8):
        raise AssertionError(f"pyramid: example gates fail {gates}")
    contacts = pipe.collide(state)
    errs, recs = group_paths(solver, state, ctl, contacts, DT, "pyramid")
    Mi, rhs = recs[0]["chol"]
    args, kw = recs[0]["pgs"]
    b2_ms = time_ms(lambda: pgs.pgs_solve_fused(*args, **kw), queued=True)
    b2_plain_ms = time_ms(lambda: pgs.pgs_solve_fused_plain(*args, **kw),
                          n=10)
    # every entry: contact_cap=0
    full = nt.SolverFeatherstone(model, contact_iterations=16, contact_cap=0)
    rec = {}
    before = kernel_launches()
    full.step(state, None, ctl, contacts, DT, record=rec)
    full_launches = [a - b_ for a, b_ in zip(kernel_launches(), before)]
    fargs, fkw = rec["pgs"]
    if fkw["c"] != 288 or pgs.kernel_instance(288, 0, 36) != "global256":
        raise AssertionError("pyramid: contact_cap=0 expected B2 at "
                             "(288, 0, 36) global256")
    e_lam, e_dqd, n_diff, _, _ = compare_pgs(fargs, fkw, BOX_W // 100)
    full_ms = time_ms(lambda: pgs.pgs_solve_fused(*fargs, **fkw),
                      queued=True)
    full_plain_ms = time_ms(lambda: pgs.pgs_solve_fused_plain(*fargs,
                                                              **fkw), n=3)
    rates, _, _ = turns(solver, state, state.clone(), ctl,
                        TURN_FRAMES * SUBSTEPS, BOX_W, DT, pipe=pipe)
    return dict(worlds=BOX_W, setup_s=setup_s, substeps=n_sub,
                launches=launches, gates=gates,
                main_env_steps_per_s=n_sub * BOX_W / elapsed,
                env_steps_per_s=sum(rates[True]) / 2,
                plain_env_steps_per_s=sum(rates[False]) / 2,
                turns_kernel=rates[True], turns_plain=rates[False],
                peak_memory_bytes=torch.cuda.max_memory_allocated(),
                active_entries_mean=float(
                    contacts.rigid_contact_mask.float().sum() / BOX_W),
                paths=errs, b1_instance=b1_inst, b2_instance=b2_inst,
                b1_max_abs_err=errs["b1 group 0"][0],
                b1=b1_times(Mi, rhs), b2_ms=b2_ms, b2_plain_ms=b2_plain_ms,
                pgs_lam_err=errs["b2 group 0"]["lam"],
                uncompacted=dict(launches=full_launches, lam_err=e_lam,
                                 dqd_err=e_dqd, guard_mismatch_rows=n_diff,
                                 ms=full_ms, plain_ms=full_plain_ms,
                                 scratch_bytes=4 * BOX_W
                                 * pgs.scratch_floats(288, 0, 36)))


def phase_domino(dev):
    """example_domino_spiral.py x 1024 under SolverXPBD(iterations=4), dt
    1/240, 4 substeps per frame, 110 frames with the first domino nudged
    (replayed from a CUDA graph of the substep): the example's gate (the
    first five dominoes tipped, up-z < 0.75) in every world, the worlds
    where all ten tipped, finite state and unit quaternions, no B1/B2
    launch; one profiled frame; env-steps/s over RATE_FRAMES eager frames
    (and over the graph's replays of the gate window)."""
    import torch
    import newton_tpu_torch as nt
    t0 = time.perf_counter()
    b, qd = domino_scene(nt, BOX_W)
    model = b.finalize(dev)
    pipe = nt.CollisionPipeline(model)
    solver = nt.SolverXPBD(model, iterations=4)
    state = model.state()
    state.body_qd = torch.as_tensor(qd, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    reset_robot_launches()
    state, gate_s = graphed_gate_run(
        lambda s: solver.step(s, None, None, pipe.collide(s), DT), state,
        DOMINO_FRAMES * SUBSTEPS, ("body_q", "body_qd", "joint_q",
                                   "joint_qd"))
    state = state.clone()
    t0 = time.perf_counter()
    xpbd_frames(solver, pipe, state, None, RATE_FRAMES)
    elapsed = time.perf_counter() - t0
    if kernel_launches() != (0, 0):
        raise AssertionError("domino: a B1/B2 kernel launched on the XPBD "
                             "path")
    check_state(state, "domino", None)
    q = state.body_q.view(BOX_W, DOMINO_N, 7)[..., 3:7]
    up_z = 1.0 - 2.0 * (q[..., 0] ** 2 + q[..., 1] ** 2)
    tipped = up_z < 0.75
    first5 = int(tipped[:, :DOMINO_N // 2].all(1).sum())
    if first5 != BOX_W:
        raise AssertionError(f"domino: the first five tipped in {first5} of "
                             f"{BOX_W} worlds")
    prof = profile_frame(lambda: xpbd_frames(solver, pipe, state, None, 1),
                         SUBSTEPS)
    n_sub = DOMINO_FRAMES * SUBSTEPS
    rate = RATE_FRAMES * SUBSTEPS * BOX_W / elapsed
    return dict(worlds=BOX_W, setup_s=setup_s, substeps=n_sub,
                gate_window_graphed_s=gate_s, env_steps_per_s=rate,
                rate_frames=RATE_FRAMES,
                graph_env_steps_per_s=n_sub * BOX_W / gate_s,
                busy_share_unprofiled=busy_unprofiled(prof, BOX_W, rate),
                worlds_first_five_tipped=first5,
                worlds_all_tipped=int(tipped.all(1).sum()),
                tipped_per_world_mean=float(tipped.float().sum(1).mean()),
                profile=prof)


# ----------------------------------------------------------------------
# cloth (phases 24-27): no TPU kernel lies on this path; the scenes are
# written against a builder module ``lib`` with the JAX package's API, so
# the CPU tests build the same scenes with both packages
# ----------------------------------------------------------------------
CLOTH_DIM = 100                       # bench.py --cloth-dim
CLOTH_CELL = 0.01
CLOTH_Z = 2.0
CLOTH_WARMUP = 10                     # bench.py's chunk
CLOTH_FRAMES = 50                     # bench.py --frames
VBD_FRAMES = 20
CLOTH_ITERS = 4                       # bench.py's SolverStyle3D iterations
GARMENT_DT = 1.0 / 480.0              # example_cloth_style3d.py
GARMENT_SUBSTEPS = 8
GARMENT_FRAMES = 50                   # tests/test_examples.py
# the garment slides off its torso from about frame 50 in both packages
# (ROADMAP C.16): "hangs on the torso" (max z > 0.9) is held through
# frame 40, the example's own frame-50 reading is reported
GARMENT_HOLD_FRAMES = 40
BENDING_FRAMES = 40                   # tests/test_examples.py
SEMI_DT = 1.0 / 2000.0                # test_semi_implicit_stable
SEMI_SUBSTEPS = 20
SEMI_FRAMES = 30
# one substep on the card against the CPU (tests/test_batched_step.py's
# tolerances), and two runs of one substep on the card (index_add_ adds
# in no fixed order)
CLOTH_CPU_TOL = {"particle_q": 2e-4, "particle_qd": 5e-3}
REPEAT_FIELDS_CLOTH = ("particle_q", "particle_qd", "body_q", "body_qd")


def cloth_bench_scene(lib, dim=CLOTH_DIM, cell=CLOTH_CELL):
    """bench.py --mode cloth: a (dim + 1)^2 grid pinned along its top row
    at z = 2 (mass 2, tri_ke 500, edge_ke 1)."""
    b = lib.ModelBuilder()
    b.add_cloth_grid(pos=(0, 0, CLOTH_Z), dim_x=dim, dim_y=dim, cell_x=cell,
                     cell_y=cell, mass=2.0, fix_top=True, tri_ke=500.0,
                     edge_ke=1.0)
    return b


def small_cloth_scene(lib):
    """tests/test_cloth_solvers.py's cloth: 6 x 6 cells of 0.1 at z = 1,
    pinned along its top row."""
    b = lib.ModelBuilder()
    b.add_cloth_grid(pos=(0, 0, 1.0), dim_x=6, dim_y=6, cell_x=0.1,
                     cell_y=0.1, mass=1.0, fix_top=True, tri_ke=500.0,
                     edge_ke=2.0)
    return b


def garment_scene(lib, dim=10, cell=0.05):
    """example_cloth_style3d.py: two vertical 10 x 10 panels either side
    of a static capsule torso over a ground plane, their top rows' outer
    thirds sewn (ke 3e3, kd 2, shrink 0.9). Returns (builder, (seam_a,
    seam_b))."""
    import numpy as np
    b = lib.ModelBuilder(gravity=-9.81)
    q_y = np.array([0.0, np.sin(np.pi / 4), 0.0, np.cos(np.pi / 4)])
    b.add_shape_capsule(-1, radius=0.16, half_height=0.2,
                        xform=np.concatenate([[0.25, 0.25, 0.9], q_y]),
                        key="torso_shape")
    b.add_ground_plane()
    q_x = np.array([np.sin(np.pi / 4), 0.0, 0.0, np.cos(np.pi / 4)])
    panels = []
    for y in (0.06, 0.46):
        panels.append(b.particle_count)
        b.add_cloth_grid(pos=(0.0, y, 1.15), rot=q_x, dim_x=dim, dim_y=dim,
                         cell_x=cell, cell_y=cell, mass=0.4, radius=0.02,
                         tri_ke=800.0, tri_kd=8.0, edge_ke=0.5)
    top_a = [panels[0] + dim * (dim + 1) + i for i in range(dim + 1)]
    top_b = [panels[1] + dim * (dim + 1) + i for i in range(dim + 1)]
    third = (dim + 1) // 3
    seam_a = top_a[:third] + top_a[-third:]
    seam_b = top_b[:third] + top_b[-third:]
    b.sew_particles(seam_a, seam_b, ke=3.0e3, kd=2.0, shrink=0.9)
    return b, (seam_a, seam_b)


def bending_scene(lib):
    """example_cloth_bending.py: two 8 x 8 sheets pinned at their top
    rows, edge_ke 0.02 and 20. Returns (builder, [(start, end)] per
    sheet)."""
    b = lib.ModelBuilder(gravity=-9.81)
    spans = []
    for i, edge_ke in enumerate((0.02, 20.0)):
        start = b.particle_count
        b.add_cloth_grid(pos=(0.0, 0.6 * i, 1.2), dim_x=8, dim_y=8,
                         cell_x=0.06, cell_y=0.06, mass=0.5, fix_top=True,
                         tri_ke=500.0, tri_kd=5.0, edge_ke=edge_ke,
                         edge_kd=0.02)
        spans.append((start, b.particle_count))
    return b, spans


def soft_grid_scene(lib, n=4):
    """A soft block of n^3 cells of 0.1 (five tetrahedra each) with
    example_softbody_hanging.py's material (density 80, k_mu = k_lambda
    = 2e3, k_damp 2), pinned at its x = 0 face."""
    b = lib.ModelBuilder()
    b.add_soft_grid(pos=(0.0, -0.2, 1.0), rot=None, vel=(0, 0, 0),
                    dim_x=n, dim_y=n, dim_z=n, cell_x=0.1, cell_y=0.1,
                    cell_z=0.1, density=80.0, k_mu=2.0e3, k_lambda=2.0e3,
                    k_damp=2.0, fix_left=True, radius=0.03)
    return b


def cloth_run(solver, state, frames, substeps, dt, pipe=None):
    """``frames`` frames of ``substeps`` substeps (collide each substep
    where a pipeline is given), then one synchronize."""
    import torch
    for _ in range(frames * substeps):
        state = solver.step(state, None, None,
                            None if pipe is None else pipe.collide(state), dt)
    torch.cuda.synchronize()
    return state


def cloth_gates(model, state, label, pinned_z=CLOTH_Z, drape=True):
    """test_cloth_hangs' gates at the bench cloth's cell: finite, the
    pinned row within 1e-3 of its height and, with ``drape``, the free
    vertices' mean z below it and no triangle edge longer than 2.5 x its
    rest length (the last two are reported either way)."""
    import torch
    q = state.particle_q
    if not bool(torch.isfinite(q).all()):
        raise AssertionError(f"{label}: non-finite particle state")
    fixed = model.particle_inv_mass == 0
    pin_err = float((q[fixed, 2] - pinned_z).abs().max())
    z_free = float(q[~fixed, 2].mean())
    ti = model.tri_indices.long()
    q0 = model.particle_q
    stretch = float(((q[ti[:, 0]] - q[ti[:, 1]]).norm(dim=-1)
                     / (q0[ti[:, 0]] - q0[ti[:, 1]]).norm(dim=-1)).max())
    if pin_err > 1e-3 or (drape and (not z_free < pinned_z
                                     or stretch > 2.5)):
        raise AssertionError(f"{label}: pinned row off by {pin_err:.3g}, "
                             f"free mean z {z_free:.4f}, edge stretch "
                             f"{stretch:.3f}")
    return dict(pinned_err=pin_err, free_z_mean=z_free,
                edge_stretch_max=stretch)


def cloth_vs_cpu(dev, builder, make_solver, state, dt, label, pipe=False,
                 gate=True):
    """One substep on the card against the same substep on the CPU from
    the same state (the model finalized again on each), with ``gate`` held
    to its tolerances, then two runs of that substep on the card, which
    must be equal bit for bit (every sum in a fixed order)."""
    import torch
    import newton_tpu_torch as nt
    out, spread = {}, {}
    for side, d in (("card", dev), ("cpu", "cpu")):
        m = builder.finalize(d)
        s = state.to(d)
        c = nt.CollisionPipeline(m).collide(s) if pipe else None
        solver = make_solver(m)
        out[side] = solver.step(s, None, None, c, dt)
        if side == "card":
            again = solver.step(s, None, None, c, dt)
            spread = {n: float(torch.cat([
                (getattr(out[side], n) - getattr(again, n)).abs().flatten(),
                torch.zeros(1, device=d)]).max())
                for n in REPEAT_FIELDS_CLOTH}
            same = {n: torch.equal(getattr(out[side], n), getattr(again, n))
                    for n in REPEAT_FIELDS_CLOTH}
    err = {}
    for n, tol in CLOTH_CPU_TOL.items():
        ok, err[n] = close(getattr(out["card"], n).cpu(),
                           getattr(out["cpu"], n), tol, tol)
        if gate and not ok:
            raise AssertionError(f"{label}: {n} card vs CPU off tolerance "
                                 f"({err[n]:.3g})")
    for n in REPEAT_FIELDS_CLOTH:
        if not same[n]:
            raise AssertionError(f"{label}: two runs of a substep differ in "
                                 f"{n} by {spread[n]:.3g}")
    torch.cuda.synchronize()
    return dict(vs_cpu=err, repeat_max_diff=spread)


def no_tpu_kernel(label):
    """No B1-B4 launch since the last resets (no TPU kernel lies on the
    cloth path)."""
    if kernel_launches() != (0, 0) or any(mpm_launches().values()):
        raise AssertionError(f"{label}: a B1-B4 kernel launched on the "
                             "cloth path")


def reset_all_launches():
    reset_robot_launches()
    reset_mpm_launches()


def bench_cloth_phase(dev, make_solver, frames, label, pcg=False,
                      drape=True):
    """The bench cloth under one solver: setup, CLOTH_WARMUP warm-up and
    ``frames`` timed frames of SUBSTEPS substeps at DT, the gates (the
    drape gates with ``drape``), one profiled frame, the card against the
    CPU from the timed run's end state (without ``drape``: gated from
    rest, reported from the end state); vertex-steps/s."""
    import torch
    import newton_tpu_torch as nt
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    b = cloth_bench_scene(nt)
    model = b.finalize(dev)
    solver = make_solver(model)
    state = model.state()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    reset_all_launches()
    state = cloth_run(solver, state, CLOTH_WARMUP, SUBSTEPS, DT)
    t0 = time.perf_counter()
    state = cloth_run(solver, state, frames, SUBSTEPS, DT)
    elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    no_tpu_kernel(label)
    gates = cloth_gates(model, state, label, drape=drape)
    N = model.particle_count
    res = dict(vertices=N, setup_s=setup_s, substeps=frames * SUBSTEPS,
               vertex_steps_per_s=N * frames * SUBSTEPS / elapsed,
               peak_memory_bytes=peak, gates=gates)
    if pcg:
        # the PD system's CG: 8 iterations from zero on the slow test's
        # right-hand side (tests/test_cloth_solvers.py:186-195)
        diag = solver._diag(DT)
        rhs = diag[:, None] * state.particle_q
        x = solver._pcg(torch.zeros_like(rhs), rhs, diag, solver.w,
                        solver.PCG_ITERATIONS)
        rel = float((rhs - solver._apply_A(x, diag, solver.w)).norm()
                    / rhs.norm())
        if not rel < 1e-3:
            raise AssertionError(f"{label}: PCG residual {rel:.3g} >= 1e-3")
        res["pcg_relative_residual"] = rel
    prof = profile_frame(lambda: cloth_run(solver, state, 1, SUBSTEPS, DT),
                         SUBSTEPS)
    if prof is not None and prof["memcpy_dtoh"]:
        raise AssertionError(f"{label}: {prof['memcpy_dtoh']} device-to-"
                             "host copies in a profiled frame")
    res["profile"] = prof
    res["busy_share_unprofiled"] = busy_unprofiled(
        prof, N, res["vertex_steps_per_s"])
    if hasattr(solver, "colors"):
        res["colors"] = [len(c) for c in solver.colors]
    if drape:
        res.update(cloth_vs_cpu(dev, b, make_solver, state, DT, label))
    else:
        # a cloth that does not hold (C.15) moves metres per frame: float32
        # rounding that differs between the card and the CPU grows within
        # one substep there, so the gate takes the substep from rest
        res.update(cloth_vs_cpu(dev, b, make_solver, model.state(), DT,
                                label))
        end = cloth_vs_cpu(dev, b, make_solver, state, DT, label, gate=False)
        res["vs_cpu_end_state"] = end["vs_cpu"]
        res["repeat_max_diff_end_state"] = end["repeat_max_diff"]
    return res


def phase_cloth_style3d(dev):
    """bench.py --mode cloth as published: SolverStyle3D(iterations=4) on
    the 100 x 100 pinned grid, no contacts."""
    import newton_tpu_torch as nt
    return bench_cloth_phase(
        dev, lambda m: nt.SolverStyle3D(m, iterations=CLOTH_ITERS),
        CLOTH_FRAMES, "cloth style3d", pcg=True)


def phase_garment(dev):
    """example_cloth_style3d.py as published: the sewn panels on the
    capsule torso, CollisionPipeline soft contacts each substep,
    SolverStyle3D(iterations=6, contact_ke=2e4), dt 1/480, 8 substeps,
    50 frames; the example's test_final, with "hangs on the torso" (max
    z > 0.9) held at every frame through GARMENT_HOLD_FRAMES and reported
    at frame 50 (ROADMAP C.16); a card vs CPU substep with the
    contacts."""
    import torch
    import newton_tpu_torch as nt
    t0 = time.perf_counter()
    b, (seam_a, seam_b) = garment_scene(nt)
    model = b.finalize(dev)
    pipe = nt.CollisionPipeline(model)

    def make(m):
        return nt.SolverStyle3D(m, iterations=6, contact_ke=2.0e4)
    solver = make(model)
    state = model.state()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    reset_all_launches()
    t0 = time.perf_counter()
    z_frames = []               # max z after each frame, read at the end
    for _ in range(GARMENT_FRAMES):
        for _ in range(GARMENT_SUBSTEPS):
            state = solver.step(state, None, None, pipe.collide(state),
                                GARMENT_DT)
        z_frames.append(state.particle_q[:, 2].max())
    z_frames = torch.stack(z_frames).tolist()
    elapsed = time.perf_counter() - t0
    no_tpu_kernel("garment")
    q = state.particle_q
    gap = float((q[seam_a] - q[seam_b]).norm(dim=-1).mean())
    z_max = z_frames[-1]
    z_hold = min(z_frames[:GARMENT_HOLD_FRAMES])
    if not bool(torch.isfinite(q).all()) or not gap < 0.25 or \
            not z_hold > 0.9:
        raise AssertionError(f"garment: seam gap {gap:.3f}, max z through "
                             f"frame {GARMENT_HOLD_FRAMES} down to "
                             f"{z_hold:.3f}")
    n_sub = GARMENT_FRAMES * GARMENT_SUBSTEPS
    active = int(pipe.collide(state).soft_contact_mask.sum())
    res = dict(vertices=model.particle_count, soft_pairs=pipe.soft_contact_max,
               active_soft_contacts_at_end=active, setup_s=setup_s,
               substeps=n_sub, seconds=elapsed,
               vertex_steps_per_s=model.particle_count * n_sub / elapsed,
               seam_gap=gap, z_max=z_max, z_max_min_to_hold_frame=z_hold,
               z_max_frames_5=z_frames[4::5])
    res.update(cloth_vs_cpu(dev, b, make, state, GARMENT_DT, "garment",
                            pipe=True))
    return res


def phase_vbd(dev):
    """(a) example_cloth_bending.py as published under SolverVBD(
    iterations=4), 40 frames, its test_final; (b) the bench cloth under
    SolverVBD(iterations=4) (not a published configuration: VBD's
    coloured sweep at the bench width); (c) one substep with soft
    contacts (the garment lowered into the ground plane) run twice on
    the card, equal bit for bit."""
    import torch
    import newton_tpu_torch as nt
    b, spans = bending_scene(nt)
    model = b.finalize(dev)
    solver = nt.SolverVBD(model, iterations=4)
    reset_all_launches()
    t0 = time.perf_counter()
    state = cloth_run(solver, model.state(), BENDING_FRAMES, SUBSTEPS, DT)
    elapsed = time.perf_counter() - t0
    no_tpu_kernel("bending")
    q = state.particle_q
    width = [float(q[s:e, 0].max() - q[s:e, 0].min()) for s, e in spans]
    if not bool(torch.isfinite(q).all()) or \
            not width[1] > width[0] - 0.02 or not float(q[:, 2].min()) < 1.15:
        raise AssertionError(f"bending: spans {width}, min z "
                             f"{float(q[:, 2].min()):.3f}")
    bending = dict(colors=len(solver.colors), spans=width, seconds=elapsed,
                   z_min=float(q[:, 2].min()))
    # the JAX package's VBD does not hold this cloth (ROADMAP C.15: edges
    # stretched ~12x and vertices at 50-80 m/s from the first frame, the
    # free mean z above the pinned row by frame 30): only the pinned row
    # and finiteness are gated here, the drape is reported
    grid = bench_cloth_phase(dev, lambda m: nt.SolverVBD(m, iterations=4),
                             VBD_FRAMES, "cloth vbd", drape=False)
    # (c) soft contacts: the garment lowered 1.2 m, its hems in the ground
    # plane; one substep on the card twice (bit for bit) and on the CPU
    # (reported)
    gb, _ = garment_scene(nt)
    gm = gb.finalize(dev)
    s0 = gm.state()
    s0.particle_q[:, 2] -= 1.2
    c = nt.CollisionPipeline(gm).collide(s0)
    act = int((c.soft_contact_mask & (c.soft_contact_depth > 0)).sum())
    if act == 0:
        raise AssertionError("vbd soft contacts: no active soft contact")
    soft = cloth_vs_cpu(dev, gb, lambda m: nt.SolverVBD(m, iterations=4), s0,
                        GARMENT_DT, "vbd soft contacts", pipe=True,
                        gate=False)
    soft["active_soft_contacts"] = act
    return dict(bending=bending, grid=grid, soft_contacts=soft)


def phase_semi_implicit(dev):
    """test_semi_implicit_stable's cloth (6 x 6, dt 1/2000, 20 substeps,
    30 frames) and the pinned soft block of 4^3 cells for 1 s under
    SolverSemiImplicit: finite, the pinned particles exactly in place,
    the block sagged; a card vs CPU substep of each."""
    import torch
    import newton_tpu_torch as nt
    res = {}
    for label, b, frames in (
            ("cloth", small_cloth_scene(nt), SEMI_FRAMES),
            ("soft block", soft_grid_scene(nt),
             int(round(1.0 / (SEMI_DT * SEMI_SUBSTEPS))))):
        model = b.finalize(dev)
        solver = nt.SolverSemiImplicit(model)
        s0 = model.state()
        reset_all_launches()
        t0 = time.perf_counter()
        state = cloth_run(solver, s0, frames, SEMI_SUBSTEPS, SEMI_DT)
        elapsed = time.perf_counter() - t0
        no_tpu_kernel(f"semi-implicit {label}")
        q = state.particle_q
        pinned = model.particle_inv_mass == 0
        moved = float((q[pinned] - s0.particle_q[pinned]).abs().max())
        sag = float(s0.particle_q[:, 2].min() - q[:, 2].min())
        if not bool(torch.isfinite(q).all()) or moved != 0.0 or \
                not 0.0 < sag < 0.6:
            raise AssertionError(f"semi-implicit {label}: pinned moved "
                                 f"{moved:.3g}, sag {sag:.4f}")
        r = dict(vertices=model.particle_count,
                 tets=model.structure.tet_count,
                 substeps=frames * SEMI_SUBSTEPS, seconds=elapsed,
                 pinned_moved=moved, sag=sag)
        r.update(cloth_vs_cpu(dev, b, nt.SolverSemiImplicit, state,
                              SEMI_DT, f"semi-implicit {label}"))
        res[label] = r
    return res


# ----------------------------------------------------------------------
# phases 28-31: inverse kinematics, warm start and sleeping, equality
# rows, URDF
# ----------------------------------------------------------------------

IK_PROBLEMS = 4096                    # bench.py --worlds' default
IK_SEEDS = 4                          # bench_ik
IK_ITERS = 16                         # bench_ik
IK_REPS = 1                           # bench_ik times 5
IK_CPU_PROBLEMS = 64
IK_TIP_TOL = 0.02                     # tests/test_utils.py:87
WS_W = 4096
WS_FRAMES = 60                        # tests/test_utils.py:139
SLEEP_FRAMES = 60                     # tests/test_examples.py
WS_TURN_FRAMES = 2
EQ_W = 4096
EQ_FRAMES = 60                        # tests/test_equality.py
URDF_W = 4096
URDF_DT = 1.0 / 480.0                 # example_basic_urdf.py
URDF_SUBSTEPS = 8
URDF_FRAMES = 15                      # tests/test_examples.py
DOUBLE_PENDULUM_URDF = """<?xml version="1.0"?>
<robot name="double_pendulum">
  <link name="base">
    <inertial><mass value="0"/><inertia ixx="0" iyy="0" izz="0"
      ixy="0" ixz="0" iyz="0"/></inertial>
  </link>
  <link name="upper">
    <inertial>
      <origin xyz="0 0 -0.25"/>
      <mass value="1.0"/>
      <inertia ixx="0.02" iyy="0.02" izz="0.001" ixy="0" ixz="0" iyz="0"/>
    </inertial>
    <collision>
      <origin xyz="0 0 -0.25"/>
      <geometry><cylinder radius="0.03" length="0.5"/></geometry>
    </collision>
  </link>
  <link name="lower">
    <inertial>
      <origin xyz="0 0 -0.25"/>
      <mass value="1.0"/>
      <inertia ixx="0.02" iyy="0.02" izz="0.001" ixy="0" ixz="0" iyz="0"/>
    </inertial>
    <collision>
      <origin xyz="0 0 -0.25"/>
      <geometry><cylinder radius="0.03" length="0.5"/></geometry>
    </collision>
  </link>
  <joint name="shoulder" type="revolute">
    <parent link="base"/>
    <child link="upper"/>
    <origin xyz="0 0 1.2"/>
    <axis xyz="0 1 0"/>
    <limit lower="-3.14" upper="3.14" effort="50" velocity="10"/>
  </joint>
  <joint name="elbow" type="revolute">
    <parent link="upper"/>
    <child link="lower"/>
    <origin xyz="0 0 -0.5"/>
    <axis xyz="0 1 0"/>
    <limit lower="-3.14" upper="3.14" effort="50" velocity="10"/>
    {mimic}
  </joint>
</robot>
"""
MIMIC_TAG = '<mimic joint="shoulder" multiplier="-1" offset="0"/>'


def ik_chain_scene(lib):
    """bench_ik's chain: three 1 m links with capsules on revolute Z
    joints, the first at the origin."""
    b = lib.ModelBuilder()
    prev = -1
    for i in range(3):
        link = b.add_body(xform=[0.5 + i, 0, 0, 0, 0, 0, 1])
        b.add_shape_capsule(link, radius=0.05, half_height=0.25)
        b.add_joint_revolute(parent=prev, child=link, axis="Z",
                             xform_p=[0.5, 0, 0, 0, 0, 0, 1] if prev >= 0
                             else [0, 0, 0, 0, 0, 0, 1],
                             xform_c=[-0.5, 0, 0, 0, 0, 0, 1])
        prev = link
    return b


def ik_targets(n, seed):
    """bench_ik's targets (n, 3): angle U(0, 2 pi), radius U(0.5, 2.4),
    z 0, from a seeded numpy generator (all within the chain's 3 m
    reach)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    ang = rng.uniform(0.0, 2 * np.pi, n)
    rad = rng.uniform(0.5, 2.4, n)
    return np.stack([rad * np.cos(ang), rad * np.sin(ang),
                     np.zeros(n)], -1).astype(np.float32)


def ik_tip_point(model, q):
    """The chain's tip (P, 3) at coordinates (P, 3): link 2's point (0.5,
    0, 0)."""
    import torch
    from newton_tpu_torch.math import transform_point
    from newton_tpu_torch.sim.articulation import fk_bodies
    P = q.shape[0]
    bq, _ = fk_bodies(model, q, torch.zeros_like(q),
                      model.body_q.expand(P, -1, -1),
                      model.body_qd.expand(P, -1, -1))
    return transform_point(bq[:, 2], q.new_tensor([0.5, 0.0, 0.0]))


def ik_tip_error(model, q, targets):
    """|tip - target| (P,) of coordinates (P, 3)."""
    import torch
    return torch.linalg.vector_norm(ik_tip_point(model, q) - targets, dim=-1)


SYNC_SITES = []


def count_syncs(fn):
    """(fn's result, host synchronizations it made): CUDA's sync debug
    mode warns at each synchronizing call; the Python lines that made them
    are left in SYNC_SITES."""
    import warnings
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode(1)
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # one warning per synchronizing call ("called a synchronizing CUDA
    # operation"); the mode's own notice, once per process, is not one
    SYNC_SITES[:] = [f"{w.filename}:{w.lineno}: {str(w.message)[:200]}"
                     for w in caught
                     if "called a synchronizing" in str(w.message)]
    return out, len(SYNC_SITES)


def phase_ik(dev):
    """bench_ik as published on the port: IKSolver(chain,
    [IKObjectivePosition(link=2, offset=(0.5, 0, 0))], iterations=16,
    n_seeds=4) (GAUSS seeds from the solver's generator, drawn anew in
    each solve, as a user calls it) on 4096 seeded targets: a warm-up
    solve, then 1 timed solve; finite q, tip error below 0.02 in >= 99%
    of problems, host syncs per solve (at most one), peak device memory.
    64 problems on the card against the port on the CPU, both handed one
    draw of the seeds (``IKSolver.seeds`` replaced): the residual (1e-5)
    and its Jacobian (1e-4 of its largest entry) at the seeds and at the
    card's solutions; q after one LM step from each seed off the straight
    start (seeds 1-3), one seed per solve so no best-seed choice enters,
    within 1e-4; and both packages' whole solves meet the tip gate. q of
    the whole solve and of one step from the straight start (seed 0) are
    reported, not gated: the redundant chain's straight start is singular
    (J^T J of rank 1, lambda 0.01), so float32 rounding moves q along the
    null space by ~1e-4 in one step, and more as lambda falls to 1e-8."""
    import torch
    import newton_tpu_torch as nt
    from newton_tpu_torch.ik import IKObjectivePosition, IKSolver
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = ik_chain_scene(nt).finalize(dev)
    obj = [IKObjectivePosition(link=2, offset=(0.5, 0, 0))]
    ik = IKSolver(model, obj, iterations=IK_ITERS, n_seeds=IK_SEEDS)
    tg = torch.as_tensor(ik_targets(IK_PROBLEMS, 0), device=dev)
    q0 = torch.zeros(3, device=dev)
    q = ik.solve(q0, [tg])
    torch.cuda.synchronize()
    q, syncs = count_syncs(lambda: ik.solve(q0, [tg]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(IK_REPS):
        q = ik.solve(q0, [tg])
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if not bool(torch.isfinite(q).all()):
        raise AssertionError("ik: non-finite q")
    err = ik_tip_error(model, q, tg)
    miss = int((err >= IK_TIP_TOL).sum())
    if miss > IK_PROBLEMS // 100:
        raise AssertionError(f"ik: {miss} problems with tip error >= "
                             f"{IK_TIP_TOL}")
    if syncs > 1:
        raise AssertionError(f"ik: {syncs} host syncs in one solve")
    # card against the CPU: what each LM iteration computes (the
    # residual and its forward-mode Jacobian) at the seeds and at the
    # card's solutions, then LM steps and solves from one draw of seeds
    seeds = ik.seeds(q0)
    mc = ik_chain_scene(nt).finalize("cpu")
    n = IK_CPU_PROBLEMS
    kc = IKSolver(mc, obj, iterations=IK_ITERS, n_seeds=IK_SEEDS)
    err_r = err_j = 0.0
    for x in (seeds[None].expand(n, -1, -1), q[:n, None]):
        tgt = [tg[:n, None]]
        r_d, J_d = ik.residual_and_jacobian(x.contiguous(), tgt)
        r_c, J_c = kc.residual_and_jacobian(x.cpu().contiguous(),
                                            [tgt[0].cpu()])
        err_r = max(err_r, float((r_d.cpu() - r_c).abs().max()))
        err_j = max(err_j, float((J_d.cpu() - J_c).abs().max()
                                 / J_c.abs().max()))
    if not (err_r < 1e-5 and err_j < 1e-4):
        raise AssertionError(f"ik: card vs CPU residual {err_r:.3g} (1e-5) "
                             f"or Jacobian {err_j:.3g} (1e-4 relative)")

    def pair(iterations, rows):
        """(card, CPU) solutions of the n problems from seed rows
        ``rows`` of the shared draw."""
        out = []
        for m, t, x in ((model, tg[:n], seeds[rows]),
                        (mc, tg[:n].cpu(), seeds[rows].cpu())):
            k = IKSolver(m, obj, iterations=iterations, n_seeds=IK_SEEDS)
            k.seeds = lambda q0, x=x: x
            out.append(k.solve(q0.to(m.device), [t]).cpu())
        return out
    per_seed = []
    for i in range(1, IK_SEEDS):
        a, b = pair(1, slice(i, i + 1))
        per_seed.append(float((a - b).abs().max()))
    if max(per_seed) >= 1e-4:
        raise AssertionError(f"ik: q after one LM step, card vs CPU, per "
                             f"seed 1..{IK_SEEDS - 1}: {per_seed} (1e-4)")
    a, b = pair(1, slice(0, 1))
    e0 = float((a - b).abs().max())
    tips = [ik_tip_point(mc, x) for x in (a, b)]
    e0_tip = float((tips[0] - tips[1]).norm(dim=-1).max())
    a, b = pair(IK_ITERS, slice(None))
    d = (a - b).abs().amax(1)
    e_card = ik_tip_error(mc, a, tg[:n].cpu())
    e_cpu = ik_tip_error(mc, b, tg[:n].cpu())
    if int((e_card >= IK_TIP_TOL).sum() + (e_cpu >= IK_TIP_TOL).sum()) > 2:
        raise AssertionError("ik: the card's or the CPU's 64 problems miss "
                             "the tip gate")
    return dict(problems=IK_PROBLEMS, seeds=IK_SEEDS, lm_iterations=IK_ITERS,
                solves_per_s=IK_REPS * IK_PROBLEMS / elapsed,
                seconds_per_solve=elapsed / IK_REPS,
                host_syncs_per_solve=syncs, peak_memory_bytes=peak,
                tip_error_max=float(err.max()),
                tip_error_median=float(err.median()),
                problems_missing_tip_gate=miss,
                vs_cpu_residual=err_r, vs_cpu_jacobian_rel=err_j,
                vs_cpu_one_step_q_per_seed=per_seed,
                vs_cpu_one_step_q_straight_seed=e0,
                vs_cpu_one_step_tip_straight_seed=e0_tip,
                vs_cpu_problems_apart_1e_4=int((d > 1e-4).sum()),
                vs_cpu_q_max_diff=float(d.max()),
                vs_cpu_tip_error_max=(float(e_card.max()),
                                      float(e_cpu.max())))


def sleeping_scene(lib, n):
    """example_mujoco_sleeping.py's world (three free boxes of half-extent
    0.2 at x = 0, 1, 2, dropped from 5-45 mm) replicated n times, on a
    ground plane."""
    w = lib.ModelBuilder()
    for i in range(3):
        body = w.add_body(xform=[i * 1.0, 0, 0.205 + 0.02 * i, 0, 0, 0, 1],
                          key=f"box{i}")
        w.add_shape_box(body, hx=0.2, hy=0.2, hz=0.2)
        w.add_joint_free(body)
    b = lib.ModelBuilder()
    b.replicate(w, n)
    b.add_ground_plane()
    return b


def linkage_scene(lib, n, kind):
    """tests/test_equality.py's scenes replicated n times: ``"connect"``,
    two 1 m links on revolute Y joints 0.4 m apart tied at their tips by
    a CONNECT; ``"mimic"``, the same links 1 m apart, the first joint
    mimicking the second; ``"weld"`` (test size, not in the JAX tests):
    a pendulum link and a free 0.1 m box welded at its tip."""
    w = lib.ModelBuilder()
    l1 = w.add_body(xform=[0.5, 0, 0, 0, 0, 0, 1])
    w.add_shape_capsule(l1, radius=0.05, half_height=0.25)
    j1 = w.add_joint_revolute(parent=-1, child=l1, axis="Y",
                              xform_c=[-0.5, 0, 0, 0, 0, 0, 1])
    if kind == "weld":
        box = w.add_body(xform=[1.0, 0, 0, 0, 0, 0, 1])
        w.add_shape_box(box, hx=0.1, hy=0.1, hz=0.1)
        w.add_joint_free(box)
        w.add_equality_constraint(lib.EqType.WELD, body1=box, body2=l1)
    else:
        y = 0.4 if kind == "connect" else 1.0
        l2 = w.add_body(xform=[0.5, y, 0, 0, 0, 0, 1])
        w.add_shape_capsule(l2, radius=0.05, half_height=0.25)
        j2 = w.add_joint_revolute(parent=-1, child=l2, axis="Y",
                                  xform_p=[0, y, 0, 0, 0, 0, 1],
                                  xform_c=[-0.5, 0, 0, 0, 0, 0, 1])
        if kind == "connect":
            w.add_equality_constraint(lib.EqType.CONNECT, body1=l1,
                                      body2=l2, anchor=(0.5, 0, 0))
        else:
            w.add_constraint_mimic(j1, j2, multiplier=1.0)
    b = lib.ModelBuilder()
    b.replicate(w, n)
    return b


def urdf_scene(lib, n, mimic=False):
    """example_basic_urdf.py's double pendulum through add_urdf (with
    ``mimic``, its elbow mimics the shoulder with multiplier -1)
    replicated n times."""
    w = lib.ModelBuilder(gravity=-9.81)
    w.add_urdf(DOUBLE_PENDULUM_URDF.replace("{mimic}",
                                            MIMIC_TAG if mimic else ""))
    b = lib.ModelBuilder(gravity=-9.81)
    b.replicate(w, n)
    return b


def b2_warm_cold(args, kw, label, n):
    """B2 with a warm lam0 on a substep's operands against its plain
    version: lam (1e-4) and dqd (1e-3) in every row, phase 6's
    tolerances; the rows whose guard halvings differ are counted, not
    left out (a warm start begins near the fixed point, where
    ||dlambda||^2 is rounding noise and the guard's threshold decisions
    follow the sum order). Also the guard halvings of the same operands
    started warm and cold."""
    import torch
    from newton_tpu_torch.solvers.generalized import pgs
    lam_k, dqd_k, h_k = pgs.pgs_solve_fused(*args, **kw,
                                            return_halvings=True)
    lam_p, dqd_p, h_p = pgs.pgs_solve_fused_plain(*args, **kw,
                                                  return_halvings=True)
    ok1, e_lam = close(lam_k, lam_p, 1e-4, 1e-4)
    ok2, e_dqd = close(dqd_k, dqd_p, 1e-3, 1e-3)
    if not (ok1 and ok2):
        raise AssertionError(f"{label}: B2 with a warm lam0, kernel vs "
                             f"plain off tolerance (lam {e_lam:.3g}, dqd "
                             f"{e_dqd:.3g})")
    lam0 = args[6]
    if not float(lam0.abs().max()) > 0.0:
        raise AssertionError(f"{label}: B2 got a zero warm lam0")
    cold = args[:6] + (torch.zeros_like(lam0),)
    _, _, h_cold = pgs.pgs_solve_fused_plain(*cold, **kw,
                                             return_halvings=True)
    return dict(lam_err=e_lam, dqd_err=e_dqd,
                guard_mismatch_rows=int((h_k != h_p).sum()),
                halvings_warm=int(h_p.sum()), halvings_cold=int(h_cold.sum()),
                lam0_nonzero_rows=int((lam0.abs().amax(1) > 0).sum()),
                ms=time_ms(lambda: pgs.pgs_solve_fused(*args, **kw),
                           queued=True),
                plain_ms=time_ms(lambda: pgs.pgs_solve_fused_plain(*args,
                                                                   **kw),
                                 n=10),
                shape=(kw["c"], int(kw["ld"].numel()), args[0].shape[2]),
                instance=pgs.kernel_instance(kw["c"], int(kw["ld"].numel()),
                                             args[0].shape[2]))


def b2_random_lam0(dev):
    """B2 on phase 4's random ant-shaped operands with a random nonzero
    lam0 (act x |N(0, 0.1)|): kernel vs plain as phase 4 holds them (at
    most W / 1000 envs with other guard halvings)."""
    import torch
    out = {}
    for nl, cone in ((8, False), (8, True), (0, False)):
        args, ld = random_pgs_inputs(dev, 25, nl, 14, seed=21 + nl)
        gen = torch.Generator(device=dev)
        gen.manual_seed(nl)
        lam0 = args[4] * (0.1 * torch.randn(args[6].shape, generator=gen,
                                            device=dev)).abs()
        kw = dict(iters=ITERS, omega=0.8, diag_scale=1.0, reg=1e-3, c=25,
                  ld=ld, use_cone=cone)
        e1, e2, n_diff, _, _ = compare_pgs(args[:6] + (lam0,), kw, W // 1000)
        out[f"nl={nl} cone={cone}"] = dict(lam_err=e1, dqd_err=e2,
                                           guard_mismatch_envs=n_diff)
    return out


def warm_turns(run, warm, cold, frames, n):
    """env-steps/s of the warm and the cold solver in turns (cold, warm,
    warm, cold), each continuing its own state: ``run(solver_index,
    frames)`` advances one."""
    rates = {"warm": [], "cold": []}
    for key in ("cold", "warm", "warm", "cold"):
        t0 = time.perf_counter()
        run(key, frames)
        rates[key].append(frames * SUBSTEPS * n / (time.perf_counter() - t0))
    return {k: sum(v) / 2 for k, v in rates.items()}, rates


def phase_warm_sleep(dev):
    """Contact warm start and sleeping, three scenes of 4096 worlds:
    (a) the ant under test_sleep_and_warm_start's settings
    (SolverFeatherstone(contact_iterations=4, warm_start=True,
    sleep_threshold=0.05, sleep_steps=8), zero ctrl) through
    step_batched, 60 frames of 4 substeps at dt 1/240: finite, root z in
    (0.3, 0.8) in every world; (b) example_mujoco_sleeping.py replicated
    (sleep_threshold=0.12, sleep_steps=8, plus warm_start=True) through
    step, 60 frames: its test_final in every world, and the asleep
    worlds' body_q bit-frozen over a further frame; (c) the humanoid with
    warm_start=True through top-K compaction (phase 11's configuration
    and gates, 10 + 10 frames). For each: one B1 and one B2 launch per
    substep, B2 with its warm lam0 against the plain version, the guard
    halvings of those operands warm and cold, env-steps/s warm against
    cold (the same solver without warm start) in turns from the warm
    run's end state."""
    import torch
    import newton_tpu_torch as nt
    from newton_tpu_torch.solvers.generalized import linalg
    out = {"random_lam0": b2_random_lam0(dev)}
    # (a) the ant
    model, pipe, _, state0 = build_ant(dev)
    kw = dict(contact_iterations=4, sleep_threshold=0.05, sleep_steps=8)
    solvers = {k: nt.SolverFeatherstone(model, warm_start=(k == "warm"),
                                        **kw) for k in ("warm", "cold")}
    au = model.structure.mjc_actuation
    zero = lambda n: torch.zeros((n, au.n), device=dev)  # noqa: E731
    states = {k: nt.batch_state(s.init_state(state0), WS_W)
              for k, s in solvers.items()}
    reset_robot_launches()
    st = run_frames(model, pipe, solvers["warm"], states["warm"], zero,
                    WS_FRAMES, True)
    n_sub = WS_FRAMES * SUBSTEPS
    launches = kernel_launches()
    if launches != (n_sub, n_sub):
        raise AssertionError(f"ant warm/sleep: launches {launches} in "
                             f"{n_sub} substeps")
    check_state(st, "ant warm/sleep", None)
    z = st.joint_q[:, 2]
    if not (bool((z > 0.3).all()) and bool((z < 0.8).all())):
        raise AssertionError(f"ant warm/sleep: root z in [{float(z.min())},"
                             f" {float(z.max())}]")
    rec = {}
    c = pipe.collide(st)
    solvers["warm"].step_batched(st, None, batched_control(model, zero(WS_W)),
                                 c, DT, record=rec)
    ant = b2_warm_cold(*rec["pgs"], "ant warm/sleep", WS_W)
    ant["b1"] = b1_check(*rec["chol"], "ant warm/sleep")
    ant["b1_times"] = b1_times(*rec["chol"])
    asleep = int((st.custom["sleep:count:0"] >= 8).sum())
    # the cold solver's turns continue from the warm run's end state (a
    # cold run of its own to the same time would double the window)
    states["warm"] = states["cold"] = st

    def run_ant(key, frames):
        states[key] = run_frames(model, pipe, solvers[key], states[key],
                                 zero, frames, True)
    rate, rates = warm_turns(run_ant, "warm", "cold", WS_TURN_FRAMES, WS_W)
    out["ant"] = dict(worlds=WS_W, substeps=n_sub, launches=launches,
                      root_z=(float(z.min()), float(z.max())),
                      worlds_asleep=asleep, b2=ant,
                      env_steps_per_s_warm=rate["warm"],
                      env_steps_per_s_cold=rate["cold"], turns=rates)
    # (b) the sleeping boxes
    b = sleeping_scene(nt, WS_W)
    model = b.finalize(dev)
    pipe = nt.CollisionPipeline(model)
    kw = dict(sleep_threshold=0.12, sleep_steps=8)
    solvers = {k: nt.SolverFeatherstone(model, warm_start=(k == "warm"),
                                        **kw) for k in ("warm", "cold")}
    s0 = nt.eval_fk(model, model.joint_q0, model.joint_qd0, model.state())
    states = {k: s.init_state(s0) for k, s in solvers.items()}
    ctl = model.control()
    reset_robot_launches()
    n_sub = SLEEP_FRAMES * SUBSTEPS
    st = run_steps(solvers["warm"], states["warm"], ctl, n_sub, DT, True,
                   pipe=pipe)
    launches = kernel_launches()
    if launches != (n_sub, n_sub):
        raise AssertionError(f"sleeping boxes: launches {launches} in "
                             f"{n_sub} substeps")
    cnt = st.custom["sleep:count:0"]
    asleep = cnt >= 8
    qd = st.body_qd.view(WS_W, 3, 6)
    zb = st.body_q[:, 2].view(WS_W, 3)
    gates = dict(worlds_asleep=int(asleep.sum()),
                 qd_max=float(qd.abs().max()),
                 z_err_max=float((zb - 0.2).abs().max()))
    if not (bool(asleep.all()) and gates["qd_max"] < 0.12 + 0.3
            and gates["z_err_max"] < 0.03
            and bool(torch.isfinite(st.body_q).all())):
        raise AssertionError(f"sleeping boxes: test_final fails {gates}")
    rec = {}
    nxt = solvers["warm"].step(st, None, ctl, pipe.collide(st), DT,
                               record=rec)
    for _ in range(SUBSTEPS - 1):
        nxt = solvers["warm"].step(nxt, None, ctl, pipe.collide(nxt), DT)
    still = asleep & (nxt.custom["sleep:count:0"] >= 8)
    bq0 = st.body_q.view(WS_W, 3, 7)[still]
    bq1 = nxt.body_q.view(WS_W, 3, 7)[still]
    if not torch.equal(bq0, bq1):
        raise AssertionError("sleeping boxes: an asleep world's body_q "
                             "moved over a frame")
    boxes = b2_warm_cold(*rec["pgs"], "sleeping boxes", WS_W)
    boxes["b1"] = b1_check(*rec["chol"], "sleeping boxes")
    boxes["b1_times"] = b1_times(*rec["chol"])
    boxes["d"] = solvers["warm"].groups[0].g.d
    boxes["b1_instance"] = linalg.kernel_instance(boxes["d"])
    states["warm"] = states["cold"] = nxt

    def run_boxes(key, frames):
        states[key] = run_steps(solvers[key], states[key], ctl,
                                frames * SUBSTEPS, DT, True, pipe=pipe)
    rate, rates = warm_turns(run_boxes, "warm", "cold", WS_TURN_FRAMES, WS_W)
    out["sleeping_boxes"] = dict(worlds=WS_W, substeps=n_sub,
                                 launches=launches, gates=gates,
                                 worlds_still_asleep=int(still.sum()),
                                 b2=boxes, env_steps_per_s_warm=rate["warm"],
                                 env_steps_per_s_cold=rate["cold"],
                                 turns=rates)
    # (c) the humanoid, warm, through top-K
    b = nt.ModelBuilder()
    b.add_mjcf(os.path.join(nt.ASSET_DIR, "humanoid.xml"))
    model = b.finalize(dev)
    pipe = nt.CollisionPipeline(model)
    solvers = {k: nt.SolverMuJoCo(model, iterations=ITERS,
                                  integrator="euler",
                                  warm_start=(k == "warm"))
               for k in ("warm", "cold")}
    if solvers["warm"].groups[0].tables.cap != 32:
        raise AssertionError("humanoid warm: expected top-32 compaction")
    sample = ctrl_sampler(model, dev, seed=10)
    states = {k: humanoid_reset(model, dev, seed=11) for k in solvers}
    st = run_frames(model, pipe, solvers["warm"], states["warm"], sample,
                    HUMANOID_WARMUP, True)
    reset_robot_launches()
    st = run_frames(model, pipe, solvers["warm"], st, sample, FRAMES, True)
    n_sub = FRAMES * SUBSTEPS
    launches = kernel_launches()
    if launches != (n_sub, n_sub):
        raise AssertionError(f"humanoid warm: launches {launches} in "
                             f"{n_sub} substeps")
    zmin = check_state(st, "humanoid warm", z_min=0.3)
    rec = {}
    solvers["warm"].step_batched(
        st, None, batched_control(model, sample(HUMANOID_W)),
        pipe.collide(st), DT, record=rec)
    hum = b2_warm_cold(*rec["pgs"], "humanoid warm", HUMANOID_W)
    states["warm"] = states["cold"] = st

    def run_hum(key, frames):
        states[key] = run_frames(model, pipe, solvers[key], states[key],
                                 sample, frames, True)
    rate, rates = warm_turns(run_hum, "warm", "cold", WS_TURN_FRAMES,
                             HUMANOID_W)
    out["humanoid"] = dict(worlds=HUMANOID_W, substeps=n_sub,
                           launches=launches, root_z_min=zmin, b2=hum,
                           env_steps_per_s_warm=rate["warm"],
                           env_steps_per_s_cold=rate["cold"], turns=rates)
    return out


def eq_gates(kind, state, n):
    """test_equality.py's gates in every world: CONNECT, the anchors
    within 5e-3, |q0 - q1| < 1e-3 and |q0| > 0.5; mimic, |q0 - q1| <
    2e-2; WELD, the box's origin within 5e-3 of the link's tip, its
    orientation within 1e-2 rad of the link's, and |q0| > 0.5."""
    import torch
    from newton_tpu_torch.math import (quat_conjugate, quat_mul,
                                       transform_point)
    bq = state.body_q.view(n, 2, 7)
    q = state.joint_q.view(n, -1)
    if kind == "connect":
        p1 = transform_point(bq[:, 0], bq.new_tensor([0.5, 0.0, 0.0]))
        p2 = transform_point(bq[:, 1], bq.new_tensor([0.5, -0.4, 0.0]))
        g = dict(drift=float((p1 - p2).norm(dim=-1).max()),
                 q_diff=float((q[:, 0] - q[:, 1]).abs().max()),
                 q0_min=float(q[:, 0].abs().min()))
        ok = g["drift"] < 5e-3 and g["q_diff"] < 1e-3 and g["q0_min"] > 0.5
    elif kind == "mimic":
        g = dict(q_diff=float((q[:, 0] - q[:, 1]).abs().max()))
        ok = g["q_diff"] < 2e-2
    else:
        tip = transform_point(bq[:, 0], bq.new_tensor([0.5, 0.0, 0.0]))
        qe = quat_mul(bq[:, 1, 3:7], quat_conjugate(bq[:, 0, 3:7]))
        ang = 2.0 * torch.atan2(qe[:, :3].norm(dim=-1), qe[:, 3].abs())
        g = dict(drift=float((tip - bq[:, 1, :3]).norm(dim=-1).max()),
                 angle=float(ang.max()), q0_min=float(q[:, 0].abs().min()))
        ok = g["drift"] < 5e-3 and g["angle"] < 1e-2 and g["q0_min"] > 0.5
    if not ok or not bool(torch.isfinite(state.body_q).all()):
        raise AssertionError(f"equality {kind}: gates fail {g}")
    return g


def phase_equality(dev):
    """Equality rows, each scene replicated 4096 times through step with
    SolverFeatherstone's defaults, 60 frames of 4 substeps at dt 1/240,
    no contacts (as tests/test_equality.py): the CONNECT linkage, the
    mimic pair and a WELD (linkage_scene), each with its gates in every
    world, per substep one B1 launch on M + dt Kd and one of B1 without
    the inverse (``chol_solve``) on the equality system, r = 3, 1 and 6,
    the latter held against its plain version and timed beside
    torch.linalg.solve(A, rhs), a kernel vs plain step."""
    import torch
    import newton_tpu_torch as nt
    from newton_tpu_torch.solvers.generalized import linalg
    out = {}
    for kind, r in (("connect", 3), ("mimic", 1), ("weld", 6)):
        model = linkage_scene(nt, EQ_W, kind).finalize(dev)
        solver = nt.SolverFeatherstone(model)
        grp = solver.groups[0]
        if len(solver.groups) != 1 or grp.tables.eq.rows != r:
            raise AssertionError(f"equality {kind}: expected one group with "
                                 f"{r} equality rows")
        state = nt.eval_fk(model, model.joint_q0, model.joint_qd0,
                           model.state())
        ctl = model.control()
        reset_robot_launches()
        n_sub = EQ_FRAMES * SUBSTEPS
        t0 = time.perf_counter()
        state = run_steps(solver, state, ctl, n_sub, DT, True)
        elapsed = time.perf_counter() - t0
        launches = kernel_launches()
        eq_launches = solve_launches()
        if launches != (n_sub, 0) or eq_launches != n_sub:
            raise AssertionError(f"equality {kind}: launches {launches}, "
                                 f"{eq_launches} of chol_solve in {n_sub} "
                                 f"substeps")
        gates = eq_gates(kind, state, EQ_W)
        rec = {}
        k = solver.step(state, None, ctl, None, DT, record=rec)
        p = solver.step(state, None, ctl, None, DT, kernels=False)
        paths = {}
        for name, atol in (("joint_q", 2e-4), ("joint_qd", 5e-3),
                           ("body_q", 2e-4)):
            ok, paths[name] = close(getattr(k, name), getattr(p, name),
                                    atol, atol)
            if not ok:
                raise AssertionError(f"equality {kind}: {name} kernel vs "
                                     f"plain step off tolerance")
        A, rhs = rec["eq"]
        out[kind] = dict(
            worlds=EQ_W, substeps=n_sub, launches=launches,
            eq_launches=eq_launches, gates=gates,
            env_steps_per_s=n_sub * EQ_W / elapsed, rows=r,
            d=grp.g.d, paths=paths,
            b1_eq=b1s_check(A, rhs, f"equality {kind}"),
            b1_eq_times=b1s_times(A, rhs),
            b1_eq_instance=linalg.kernel_instance(r),
            b1_m=b1_check(*rec["chol"], f"equality {kind} M"),
            b1_m_instance=linalg.kernel_instance(grp.g.d))
    return out


# ---------------------------------------------------------------------------
# phases 32-36: the rest of the generalized solvers
# ---------------------------------------------------------------------------

NQP_W = 4096                          # phase 32: the ant under the Newton QP
BALL_W = 4096                         # phase 32: the resting ball
BALL_DT = 0.002                       # tests/test_parity_mujoco.py:188
BALL_STEPS = 250                      # 0.5 s (the test runs 1 s)
FINGER_W = 4096                       # phase 34
FINGER_FRAMES = 180                   # 3 s at 4 x 1/240
FINGER_PULL_S = 1.5                   # example_tendon_finger.py
FINGER_EAGER_FRAMES = 2               # launches counted, the main rate
ARM_W = 4096                          # phase 35
ARM_DT = 0.002                        # muscle_arm.xml's timestep
ARM_STEPS = 150
PAIR_W = 4096                         # phase 35: SolverSemiImplicit muscles
PAIR_STEPS = 200                      # tests/test_solvers.py:140
STACK_W = 1024                        # phase 36
STACK_FRAMES = 60                     # the example runs 120: cut for time
FOURBAR_W = 4096
FOURBAR_FRAMES = 60                   # the example runs 120: cut for time
ISLAND_W = 1024
ISLAND_STEPS = 30                     # tests/test_kamino_islands.py: 60
PARITY_W = 64                         # the card against the CPU, one substep
HEAVY_ZS = (0.25, 0.75, 1.25)         # example_heavy_stack_kamino.py
MUSCLE_ARM = "muscle_arm.xml"         # newton_tpu_torch/assets

# example_tendon_finger.py's MJCF (newton_tpu/examples): a two-segment
# finger flexed by a spatial tendon over a wrap cylinder at each knuckle
FINGER_MJCF = """
<mujoco model="finger">
  <option gravity="0 0 -9.81" timestep="0.004"/>
  <worldbody>
    <site name="origin" pos="-0.02 0 -0.02"/>
    <body name="proximal" pos="0 0 0">
      <joint name="mcp" type="hinge" axis="0 1 0" range="-5 95"
             damping="0.05"/>
      <geom name="pseg" type="capsule" fromto="0 0 0 0.05 0 0" size="0.009"/>
      <geom name="pwrap" type="cylinder" pos="0.0 0 -0.012" zaxis="0 1 0"
            size="0.008 0.012" contype="0" conaffinity="0"/>
      <site name="pal" pos="0.025 0 -0.011"/>
      <body name="distal" pos="0.05 0 0">
        <joint name="pip" type="hinge" axis="0 1 0" range="-5 110"
               damping="0.05"/>
        <geom name="dseg" type="capsule" fromto="0 0 0 0.04 0 0"
              size="0.008"/>
        <geom name="dwrap" type="cylinder" pos="0.0 0 -0.011" zaxis="0 1 0"
              size="0.007 0.011" contype="0" conaffinity="0"/>
        <site name="tip" pos="0.035 0 -0.009"/>
      </body>
    </body>
  </worldbody>
  <tendon>
    <spatial name="flexor" stiffness="45" damping="0.3">
      <site site="origin"/>
      <geom geom="pwrap"/>
      <site site="pal"/>
      <geom geom="dwrap"/>
      <site site="tip"/>
    </spatial>
  </tendon>
  <actuator>
    <motor name="pull" tendon="flexor" gear="1" ctrlrange="-8 0"
           ctrllimited="true"/>
  </actuator>
</mujoco>
"""

# tests/test_parity_mujoco.py:73's resting ball
BALL_MJCF = """
<mujoco model="ball">
  <option gravity="0 0 -9.81" timestep="0.002"/>
  <worldbody>
    <geom type="plane" size="5 5 0.1"/>
    <body name="ball" pos="0 0 0.25">
      <freejoint/>
      <geom type="sphere" size="0.1" density="1000"/>
    </body>
  </worldbody>
</mujoco>
"""


def replicated(lib, sub, n):
    """``sub`` alone for n = 1, else n copies of it, one world each, under
    its gravity."""
    if n == 1:
        return sub
    b = lib.ModelBuilder(gravity=sub.gravity)
    b.replicate(sub, n)
    return b


def mjcf_scene(lib, xml, n):
    """An MJCF text imported (through a temporary file: the port's importer
    reads files), replicated to n worlds."""
    import tempfile
    r = lib.ModelBuilder()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "scene.xml")
        with open(path, "w") as f:
            f.write(xml)
        r.add_mjcf(path)
    return replicated(lib, r, n)


def heavy_stack_scene(lib, n):
    """example_heavy_stack_kamino.py: three 0.5 m boxes stacked at z =
    0.25, 0.75, 1.25, densities 1000, 1000 and 100000 (a 100:1 mass
    ratio), free joints in one articulation, a ground plane."""
    r = lib.ModelBuilder()
    r.add_articulation()
    for z, dn in zip(HEAVY_ZS, (1000.0, 1000.0, 100000.0)):
        body = r.add_body(xform=[0, 0, z, 0, 0, 0, 1])
        r.add_shape_box(body, hx=0.25, hy=0.25, hz=0.25,
                        cfg=lib.ShapeConfig(density=dn))
        r.add_joint_free(body)
    r.add_ground_plane()
    return replicated(lib, r, n)



def fourbar_scene(lib, n):
    """example_fourbar_kamino.py: crank and rocker on revolute joints about
    y, a free coupler closing the loop through two CONNECT constraints."""
    r = lib.ModelBuilder()
    crank = r.add_body(xform=[0.0, 0, 0.5, 0, 0, 0, 1], key="crank")
    r.add_shape_capsule(crank, radius=0.04, half_height=0.25)
    r.add_joint_revolute(parent=-1, child=crank, axis="Y",
                         xform_c=[0, 0, -0.5, 0, 0, 0, 1])
    rocker = r.add_body(xform=[1.0, 0, 0.4, 0, 0, 0, 1], key="rocker")
    r.add_shape_capsule(rocker, radius=0.04, half_height=0.2)
    r.add_joint_revolute(parent=-1, child=rocker, axis="Y",
                         xform_p=[1.0, 0, 0, 0, 0, 0, 1],
                         xform_c=[0, 0, -0.4, 0, 0, 0, 1])
    coupler = r.add_body(xform=[0.5, 0, 0.9, 0, 0, 0, 1], key="coupler")
    r.add_shape_capsule(coupler, radius=0.04, half_height=0.45)
    r.add_joint_free(coupler)
    r.add_equality_constraint(lib.EqType.CONNECT, body1=crank, body2=coupler,
                              anchor=(0.0, 0.0, 0.5))
    r.add_equality_constraint(lib.EqType.CONNECT, body1=rocker,
                              body2=coupler, anchor=(0.0, 0.0, 0.4))
    return replicated(lib, r, n)


def fourbar_drift(body_q):
    """The loop's gap (W,): the crank tip against the coupler's end
    (example_fourbar_kamino.py's test_final), body_q (W, 3, 7)."""
    import numpy as np
    import torch
    from newton_tpu_torch.core.host_math import (np_transform_inverse,
                                                 np_transform_point)
    from newton_tpu_torch.math import transform_point
    a2 = np_transform_point(np_transform_inverse(
        np.array([0.5, 0, 0.9, 0, 0, 0, 1.0])), np.array([0.0, 0.0, 1.0]))

    def pt(x, p):
        return transform_point(x, torch.as_tensor(
            p, dtype=x.dtype, device=x.device).expand(*x.shape[:-1], 3))
    tip_c = pt(body_q[:, 0], [0.0, 0.0, 0.5])
    tip_k = pt(body_q[:, 2], a2)
    return torch.linalg.vector_norm(tip_c - tip_k, dim=-1)


def stacks_scene(lib, n_stacks=3, height=2, n=1, spacing=2.0, h=0.1):
    """tests/test_kamino_islands.py:build_stacks: stacks of boxes in their
    own collision groups (the ground pairs with all), so the contact plan
    splits into islands; n worlds of it."""
    r = lib.ModelBuilder(gravity=-9.81)
    for s in range(n_stacks):
        cfg = r.default_shape_cfg.copy()
        cfg.mu = 0.7
        cfg.collision_group = s + 1
        for i in range(height):
            bb = r.add_body(xform=[s * spacing, 0.0, h + 2 * h * 1.01 * i,
                                   0, 0, 0, 1], key=f"s{s}b{i}")
            r.add_shape_box(bb, hx=h, hy=h, hz=h, cfg=cfg)
            r.add_joint_free(bb)
    gcfg = r.default_shape_cfg.copy()
    gcfg.mu = 0.7
    gcfg.collision_group = -1
    r.add_ground_plane(cfg=gcfg)
    return replicated(lib, r, n)


def muscle_pair_scene(lib, n, passive=False):
    """tests/test_solvers.py:140's muscle between two free 0.2 m boxes 1 m
    apart (f0 50, lm 0.5, lt 0.1), no gravity; with ``passive`` :356's
    variant (2 m apart, f0 0, passive_ke 100, passive_kd 5, lm 1)."""
    r = lib.ModelBuilder(gravity=0.0)
    b1 = r.add_body(xform=[0, 0, 1, 0, 0, 0, 1])
    r.add_shape_box(b1, hx=0.1, hy=0.1, hz=0.1)
    r.add_joint_free(b1)
    b2 = r.add_body(xform=[2.0 if passive else 1.0, 0, 1, 0, 0, 0, 1])
    r.add_shape_box(b2, hx=0.1, hy=0.1, hz=0.1)
    r.add_joint_free(b2)
    if passive:
        r.add_muscle([b1, b2], [(0.1, 0, 0), (-0.1, 0, 0)], f0=0.0, lm=1.0,
                     lt=0.0, lmax=3.0, pen=0.0, passive_ke=100.0,
                     passive_kd=5.0)
    else:
        r.add_muscle([b1, b2], [(0.1, 0, 0), (-0.1, 0, 0)], f0=50.0,
                     lm=0.5, lt=0.1, lmax=1.0, pen=0.1)
    return replicated(lib, r, n)


def phase_urdf(dev):
    """example_basic_urdf.py's double pendulum through the port's
    add_urdf, replicated 4096 times, through step (dt 1/480, 8 substeps
    per frame, 15 frames, the shoulder started at pi / 2): its test_final
    in every world (finite, the shoulder off pi / 2 by > 0.01, max z <
    1.3), one B1 launch per substep (d = 2); the same robot with the
    elbow mimicking the shoulder (multiplier -1) through a <mimic> tag:
    |q_elbow + q_shoulder| < 2e-2 in every world, and one more launch per
    substep of B1 without the inverse (r = 1)."""
    import numpy as np
    import torch
    import newton_tpu_torch as nt
    out = {}
    for mimic in (False, True):
        label = "mimic" if mimic else "double pendulum"
        t0 = time.perf_counter()
        model = urdf_scene(nt, URDF_W, mimic).finalize(dev)
        solver = nt.SolverFeatherstone(model)
        q0 = model.joint_q0.clone().view(URDF_W, 2)
        q0[:, 0] = np.pi / 2
        if mimic:
            q0[:, 1] = -np.pi / 2
        state = nt.eval_fk(model, q0.reshape(-1), model.joint_qd0,
                           model.state())
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        ctl = model.control()
        reset_robot_launches()
        n_sub = URDF_FRAMES * URDF_SUBSTEPS
        t0 = time.perf_counter()
        state = run_steps(solver, state, ctl, n_sub, URDF_DT, True)
        elapsed = time.perf_counter() - t0
        launches = kernel_launches()
        eq_launches = solve_launches()
        if launches != (n_sub, 0) or eq_launches != (n_sub if mimic else 0):
            raise AssertionError(f"urdf {label}: launches {launches}, "
                                 f"{eq_launches} of chol_solve in {n_sub} "
                                 f"substeps")
        jq = state.joint_q.view(URDF_W, 2)
        zmax = float(state.body_q[:, 2].max())
        g = dict(shoulder_off_min=float((jq[:, 0] - np.pi / 2).abs().min()),
                 z_max=zmax)
        ok = (bool(torch.isfinite(state.body_q).all())
              and bool(torch.isfinite(state.joint_q).all())
              and g["shoulder_off_min"] > 0.01 and zmax < 1.3)
        if mimic:
            g["mimic_err"] = float((jq[:, 1] + jq[:, 0]).abs().max())
            ok = ok and g["mimic_err"] < 2e-2
        if not ok:
            raise AssertionError(f"urdf {label}: gates fail {g}")
        rec = {}
        solver.step(state, None, ctl, None, URDF_DT, record=rec)
        r = dict(worlds=URDF_W, setup_s=setup_s, substeps=n_sub,
                 launches=launches, eq_launches=eq_launches, gates=g,
                 env_steps_per_s=n_sub * URDF_W / elapsed,
                 b1=b1_check(*rec["chol"], f"urdf {label}"),
                 b1_times=b1_times(*rec["chol"]))
        if mimic:
            r["b1_eq"] = b1s_check(*rec["eq"], "urdf mimic")
        out[label] = r
    return out


def slice_kernel_entries(eq, ws, urdf, b1_src, b2_src):
    """The kernels line's entries of phases 29-31: B1 without the inverse
    on the equality systems (r = 3, 1, 6), B1 on the sleeping boxes and
    the URDF pendulum; B2 with a warm lam0 on the ant, the boxes and the
    humanoid."""
    out = []
    for kind, r, what in (("connect", 3, "CONNECT linkage"),
                          ("mimic", 1, "mimic pair"), ("weld", 6, "WELD")):
        v = eq[kind]
        t = v["b1_eq_times"]
        out.append(dict(
            name=f"chol_solve [{v['b1_eq_instance']}] r={r} W={EQ_W}",
            **b1_src, instance=v["b1_eq_instance"],
            path=f"{what} x 4096, the equality system r = {r}: B1 without "
                 "the inverse, once per substep (phase 30)",
            launches=v["eq_launches"], max_abs_err=v["b1_eq"][0],
            ms=t["ms"], plain_ms=t["plain_ms"],
            **bound_fields("chol_solve", t["ms"], d=r, W=EQ_W),
            library_ms=t["library_ms"]))
    for label, path, d, n, launches, err, t in (
            (ws["sleeping_boxes"]["b2"]["b1_instance"], "sleeping boxes "
             "x 4096, three free boxes per world, warm start (phase 29)",
             ws["sleeping_boxes"]["b2"]["d"], WS_W,
             ws["sleeping_boxes"]["launches"][0],
             ws["sleeping_boxes"]["b2"]["b1"][0],
             ws["sleeping_boxes"]["b2"]["b1_times"]),
            ("reg8", "URDF double pendulum x 4096, add_urdf (phase 31)", 2,
             URDF_W, urdf["double pendulum"]["launches"][0],
             urdf["double pendulum"]["b1"][0],
             urdf["double pendulum"]["b1_times"])):
        out.append(dict(
            name=f"chol_inv_solve [{label}] d={d} W={n}", **b1_src,
            instance=label, path=path, launches=launches, max_abs_err=err,
            ms=t["ms"], plain_ms=t["plain_ms"],
            **bound_fields("chol_inv_solve", t["ms"], d=d, W=n),
            library_ms=t["library_ms"]))
    for key, path, n in (
            ("ant", "ant x 4096, contact_iterations=4, warm lam0 "
             "(phase 29)", WS_W),
            ("sleeping_boxes", "sleeping boxes x 4096, warm lam0 "
             "(phase 29)", WS_W),
            ("humanoid", "humanoid x 4096, top-32 compaction, warm lam0 "
             "(phase 29)", HUMANOID_W)):
        v = ws[key]["b2"]
        c, nl, d = v["shape"]
        it = 4 if key == "ant" else (16 if key == "sleeping_boxes"
                                     else ITERS)
        out.append(dict(
            name=f"pgs_solve_fused [{v['instance']}, warm] {v['shape']} "
                 f"W={n}", **b2_src, instance=v["instance"], path=path,
            launches=ws[key]["launches"][1], max_abs_err=v["lam_err"],
            ms=v["ms"], plain_ms=v["plain_ms"],
            **bound_fields("pgs_solve_fused", v["ms"], c=c, nl=nl, d=d, W=n,
                           iters=it)))
    return out


def gen_launches():
    """Launches of B1, B1 without the inverse and B2 since the last
    reset_robot_launches()."""
    return kernel_launches() + (solve_launches(),)


def slice_batched(x, n):
    """The first n envs of a batched State or Control (custom entries
    too)."""
    import dataclasses
    import torch
    kw = {}
    for f in dataclasses.fields(x):
        v = getattr(x, f.name)
        if isinstance(v, torch.Tensor):
            kw[f.name] = v[:n].clone()
        elif f.name == "custom":
            kw[f.name] = {k: t[:n].clone() for k, t in v.items()}
    return dataclasses.replace(x, **kw)


def slice_flat(state, ctl, n, sub):
    """The first n worlds of a flat State and Control of a model
    replicated from the one-world builder ``sub`` (its bodies, coordinates,
    dofs, actuators and muscles per world)."""
    from dataclasses import replace
    nb, nq, nd = sub.body_count, sub.joint_coord_count, sub.joint_dof_count
    au = sub.mjc_actuation
    A = 0 if au is None else au.n
    M = len(sub.muscle_params)
    s = world_slice(state, n, nb, nq, nd)
    if "mjc:act" in state.custom:
        s = replace(s, custom={"mjc:act":
                               state.custom["mjc:act"][:n * A].clone()})
    else:
        s = replace(s, custom={})
    custom = {}
    if "mjc:ctrl" in ctl.custom:
        custom["mjc:ctrl"] = ctl.custom["mjc:ctrl"][:n * A].clone()
    c = replace(ctl, joint_target_q=ctl.joint_target_q[:n * nq].clone(),
                joint_target_qd=ctl.joint_target_qd[:n * nd].clone(),
                joint_f=ctl.joint_f[:n * nd].clone(),
                tendon_f=None if ctl.tendon_f is None
                else ctl.tendon_f[:n * len(sub.tendon_params)].clone(),
                muscle_activations=None if ctl.muscle_activations is None
                else ctl.muscle_activations[:n * M].clone(), custom=custom)
    return s, c


def to_float64(x):
    """A Model, State or Control with every floating-point tensor cast to
    float64 (the witness runs on the CPU)."""
    from newton_tpu_torch.sim.state import map_tensors
    return map_tensors(x, lambda t: t.double() if t.is_floating_point()
                       else t)


def vs_cpu(step_d, step_c, s_d, c_d, pipe_d, pipe_c, label, n,
           substeps=1, witness=None):
    """``substeps`` substeps of n envs or worlds on the card and the same
    on the CPU from the same inputs: joint_q/body_q within 2e-4 and
    joint_qd within 5e-3 (atol = rtol, tests/test_batched_step.py:69-75);
    a world whose contact set differs between the two sides takes another
    discrete path and is counted and left out, at most one. With
    ``witness`` (step, pipeline) of the model cast to float64 on the CPU,
    a world off tolerance against the float32 CPU run is held instead to
    the same substeps in float64 (``xpbd_vs_cpu``'s rule: at a tie the
    float32 CPU run may part from exact arithmetic while the card keeps
    to it) and counted; a world that agrees with neither fails."""
    import torch
    s_c, c_c = s_d.to("cpu"), c_d.to("cpu")
    s_w = c_w = None
    if witness is not None:
        s_w, c_w = to_float64(s_c), to_float64(c_c)
    flipped = torch.zeros(n, dtype=torch.bool)
    for _ in range(substeps):
        k_d = k_c = None
        if pipe_d is not None:
            k_d, k_c = pipe_d.collide(s_d), pipe_c.collide(s_c)
            flipped |= (k_d.rigid_contact_mask.cpu() != k_c.rigid_contact_mask
                        ).view(n, -1).any(1)
        s_d = step_d(s_d, c_d, k_d)
        s_c = step_c(s_c, c_c, k_c)
        if witness is not None:
            step_w, pipe_w = witness
            s_w = step_w(s_w, c_w, None if pipe_w is None
                         else pipe_w.collide(s_w))
    if int(flipped.sum()) > 1:
        raise AssertionError(f"{label}: {int(flipped.sum())} of {n} worlds "
                             "changed their contact set between the card "
                             "and the CPU")
    out = {"worlds_left_out": int(flipped.sum())}
    held = torch.zeros(n, dtype=torch.bool)
    for name, atol in (("joint_q", 2e-4), ("joint_qd", 5e-3),
                       ("body_q", 2e-4)):
        a = getattr(s_d, name).cpu().reshape(n, -1)
        b = getattr(s_c, name).reshape(n, -1)
        ok = ((a - b).abs() <= atol + atol * b.abs()).all(1) | flipped
        if witness is not None and not bool(ok.all()):
            w = getattr(s_w, name).reshape(n, -1)
            ok64 = ((a.double() - w).abs() <= atol + atol * w.abs()).all(1)
            held |= ~ok & ok64
            ok = ok | ok64
        if not bool(ok.all()):
            e = float((a - b)[~ok].abs().max())
            raise AssertionError(f"{label}: {name} card vs CPU off "
                                 f"tolerance ({e:.3g}) in "
                                 f"{int((~ok).sum())} worlds")
        keep = ~flipped & ~held
        out[name] = float((a[keep] - b[keep]).abs().max()) \
            if bool(keep.any()) else 0.0
    if witness is not None:
        out["worlds_held_to_float64"] = int(held.sum())
    return out


def repeat_bits(step, label):
    """Two runs of one substep from the same inputs (``step`` returns a
    State): equal bit for bit in every rigid field and ``mjc:act``."""
    import torch
    a, b = step(), step()
    diff = {}
    for n in REPEAT_FIELDS_RIGID:
        x, y = getattr(a, n), getattr(b, n)
        diff[n] = float((x - y).abs().max()) if x.numel() else 0.0
        if not torch.equal(x, y):
            raise AssertionError(f"{label}: two runs of a substep differ in "
                                 f"{n} by {diff[n]:.3g}")
    if "mjc:act" in a.custom:
        if not torch.equal(a.custom["mjc:act"], b.custom["mjc:act"]):
            raise AssertionError(f"{label}: two runs differ in mjc:act")
    return diff


def batched_turns(model, pipe, solver, state, sample, frames, n):
    """env-steps/s of the kernel and plain paths of step_batched in turns
    (plain, kernel, kernel, plain)."""
    rates = {True: [], False: []}
    plain = state.clone()
    for kernels in (False, True, True, False):
        t0 = time.perf_counter()
        if kernels:
            state = run_frames(model, pipe, solver, state, sample, frames,
                               True)
        else:
            plain = run_frames(model, pipe, solver, plain, sample, frames,
                               False)
        rates[kernels].append(frames * SUBSTEPS * n
                              / (time.perf_counter() - t0))
    return dict(env_steps_per_s=sum(rates[True]) / 2,
                plain_env_steps_per_s=sum(rates[False]) / 2,
                turns_kernel=rates[True], turns_plain=rates[False])


def flat_rates(solver, state, ctl, n_sub, n, dt, pipe=None):
    """env-steps/s of the kernel and plain paths of step in turns, and one
    profiled frame of SUBSTEPS substeps."""
    rates, _, _ = turns(solver, state, state.clone(), ctl, n_sub, n, dt,
                        pipe=pipe)
    rate = sum(rates[True]) / 2
    prof = profile_frame(lambda: run_steps(solver, state, ctl, SUBSTEPS, dt,
                                           True, pipe=pipe), SUBSTEPS)
    return dict(env_steps_per_s=rate,
                plain_env_steps_per_s=sum(rates[False]) / 2,
                turns_kernel=rates[True], turns_plain=rates[False],
                profile=prof,
                busy_share_unprofiled=busy_unprofiled(prof, n, rate))


def b2_record(args, kw, label, tol=(1e-4, 1e-4, 1e-3), mismatch_div=1000):
    """B2 against its plain version on captured operands (lam within atol
    tol[0], rtol tol[1], dqd within atol tol[2], rtol tol[1]; envs whose
    guard halvings differ counted, at most W / mismatch_div), and both
    timed."""
    import torch
    from newton_tpu_torch.solvers.generalized import pgs
    n = args[0].shape[0]
    lam_k, dqd_k, h_k = pgs.pgs_solve_fused(*args, **kw,
                                            return_halvings=True)
    lam_p, dqd_p, h_p = pgs.pgs_solve_fused_plain(*args, **kw,
                                                  return_halvings=True)
    same = h_k == h_p
    n_diff = int((~same).sum())
    if n_diff > n // mismatch_div:
        raise AssertionError(f"{label} B2: {n_diff} envs with different "
                             "guard halvings")
    ok1, e1 = close(lam_k[same], lam_p[same], tol[0], tol[1])
    ok2, e2 = close(dqd_k[same], dqd_p[same], tol[2], tol[1])
    if not (ok1 and ok2):
        raise AssertionError(f"{label} B2: kernel vs plain off tolerance "
                             f"(lam {e1:.3g}, dqd {e2:.3g})")
    c, nl, d = kw["c"], int(kw["ld"].numel()), args[0].shape[2]
    return dict(shape=(c, nl, d), lam_err=e1, dqd_err=e2,
                guard_mismatch_rows=n_diff,
                symmetric=kw.get("symmetric", True),
                instance=pgs.kernel_instance(c, nl, d),
                equal_bits=bool(torch.equal(lam_k, lam_p)),
                ms=time_ms(lambda: pgs.pgs_solve_fused(*args, **kw),
                           queued=True),
                plain_ms=time_ms(lambda: pgs.pgs_solve_fused_plain(*args,
                                                                   **kw),
                                 n=10))


def phase_newton_qp(dev):
    """The Newton QP, penalty limits and no body forces: (a) the ant x 4096
    through step_batched under SolverMuJoCo(iterations=8, solver="newton",
    integrator="euler") as phase 5 (a warm-up frame, 10 checked frames,
    uniform ctrl): one B1 and no B2 per substep, phase 5's gates, host
    syncs per substep no more than the Euler PGS substep's, the masked
    solve (torch.linalg.solve_ex at (4096, 116, 116)) timed per call; (b)
    tests/test_parity_mujoco.py:73's resting ball x 4096 under the Newton
    QP, 0.5 s at dt 0.002 (the test runs 1 s): the mean normal force of
    the last 10 substeps
    within 1% of the weight and z within 2e-3 of the radius in every
    world; (c) the ant under limit_mode="penalty", apply_body_forces=False
    (PGS): one B1 and one B2 (25, 0, 14) per substep, phase 5's gates.
    Each: 64 envs on the card against the CPU, one substep twice bit for
    bit, env-steps/s in turns, peak memory."""
    import torch
    import newton_tpu_torch as nt
    out = {}
    for key, kw in (("newton", dict(solver="newton")),
                    ("penalty", dict(limit_mode="penalty",
                                     apply_body_forces=False))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        model, pipe, _, state0 = build_ant(dev)
        solver = nt.SolverMuJoCo(model, iterations=ITERS, integrator="euler",
                                 **kw)
        sample = ctrl_sampler(model, dev, seed=40)
        state = nt.batch_state(state0, NQP_W)
        state = run_frames(model, pipe, solver, state, sample, 1, True)
        reset_robot_launches()
        t0 = time.perf_counter()
        state = run_frames(model, pipe, solver, state, sample, FRAMES, True)
        elapsed = time.perf_counter() - t0
        n_sub = FRAMES * SUBSTEPS
        launches = gen_launches()
        want = (n_sub, 0 if key == "newton" else n_sub, 0)
        if launches != want:
            raise AssertionError(f"ant {key}: launches {launches} in "
                                 f"{n_sub} substeps, want {want}")
        zmin = check_state(state, f"ant {key}", z_min=0.1)
        ctl = batched_control(model, sample(NQP_W))
        contacts = pipe.collide(state)
        rec = {}
        _, syncs = count_syncs(lambda: solver.step_batched(
            state, None, ctl, contacts, DT, record=rec))
        sites = list(SYNC_SITES)
        pgs_solver = nt.SolverMuJoCo(model, iterations=ITERS,
                                     integrator="euler")
        _, syncs_pgs = count_syncs(lambda: pgs_solver.step_batched(
            state, None, ctl, contacts, DT))
        if syncs > syncs_pgs:
            raise AssertionError(f"ant {key}: {syncs} host syncs per substep"
                                 f", the Euler PGS substep {syncs_pgs}: "
                                 f"{sites}")
        r = dict(envs=NQP_W, substeps=n_sub, launches=launches,
                 root_z_min=zmin, host_syncs_per_substep=syncs,
                 host_syncs_euler_pgs=syncs_pgs,
                 main_env_steps_per_s=n_sub * NQP_W / elapsed,
                 b1=b1_check(*rec["chol"], f"ant {key}"),
                 b1_times=b1_times(*rec["chol"]))
        if key == "newton":
            H, rhs = rec["newton_H"]
            r["masked_solve_shape"] = tuple(H.shape)
            r["masked_solve_ms"] = time_ms(lambda: torch.linalg.solve_ex(
                H, rhs[..., None], check_errors=False), queued=True)
            r["masked_solves_per_substep"] = solver.newton_iterations
        else:
            r["b2"] = b2_record(*rec["pgs"], f"ant {key}")
            if r["b2"]["shape"] != (25, 0, 14):
                raise AssertionError(f"ant penalty: B2 at {r['b2']['shape']}")
        cpu_model = build_ant("cpu")[0]
        cpu_solver = nt.SolverMuJoCo(cpu_model, iterations=ITERS,
                                     integrator="euler", **kw)
        r["vs_cpu"] = vs_cpu(
            lambda s, c, k: solver.step_batched(s, None, c, k, DT),
            lambda s, c, k: cpu_solver.step_batched(s, None, c, k, DT),
            slice_batched(state, PARITY_W), slice_batched(ctl, PARITY_W),
            pipe, nt.CollisionPipeline(cpu_model), f"ant {key}", PARITY_W)
        r["repeat_max_diff"] = repeat_bits(lambda: solver.step_batched(
            state, None, ctl, contacts, DT), f"ant {key}")
        r.update(batched_turns(model, pipe, solver, state, sample, 1,
                               NQP_W))
        r["profile"] = profile_frame(lambda: run_frames(
            model, pipe, solver, state, sample, 1, True), SUBSTEPS)
        r["busy_share_unprofiled"] = busy_unprofiled(
            r["profile"], NQP_W, r["env_steps_per_s"])
        r["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        out["ant_" + key] = r
    # (b) the resting ball
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = mjcf_scene(nt, BALL_MJCF, BALL_W).finalize(dev)
    solver = nt.SolverMuJoCo(model, integrator="euler", solver="newton")
    pipe = nt.CollisionPipeline(model)
    state = nt.eval_fk(model, model.joint_q0, model.joint_qd0, model.state())
    ctl = model.control()
    reset_robot_launches()
    forces = []
    t0 = time.perf_counter()
    for k in range(BALL_STEPS):
        rec = {} if k >= BALL_STEPS - 10 else None
        state = solver.step(state, None, ctl, pipe.collide(state), BALL_DT,
                            record=rec)
        if rec is not None:
            c = rec["pgs"][1]["c"]
            forces.append(rec["lam"][:, :c].sum(1) / BALL_DT)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = gen_launches()
    if launches != (BALL_STEPS, 0, 0):
        raise AssertionError(f"resting ball: launches {launches}")
    weight = 1000 * 4 / 3 * 3.141592653589793 * 0.1 ** 3 * 9.81
    f = torch.stack(forces).mean(0)
    z = state.joint_q.view(BALL_W, 7)[:, 2]
    g = dict(force_rel_err_max=float(((f - weight) / weight).abs().max()),
             z_err_max=float((z - 0.1).abs().max()))
    if not (g["force_rel_err_max"] < 0.01 and g["z_err_max"] < 2e-3):
        raise AssertionError(f"resting ball: gates fail {g}")
    out["ball"] = dict(worlds=BALL_W, substeps=BALL_STEPS, launches=launches,
                       gates=g,
                       env_steps_per_s=BALL_STEPS * BALL_W / elapsed,
                       peak_memory_bytes=torch.cuda.max_memory_allocated())
    return out


def phase_implicit(dev):
    """The implicit integrators on the humanoid x 4096 as phase 11 (10
    warm-up and 10 checked frames, top-32 contacts, uniform ctrl):
    implicitfast (one B1 and one B2 per substep; the humanoid's tendons
    have no damping and its motors no velocity gain, so D = 0 and its
    substep equals the Euler substep within 1e-6) and implicit (no B1: LU
    by torch.linalg.solve_ex; one B2 per substep in its non-symmetric
    form, held against its twin on the captured operands within atol
    1e-5, rtol 1e-4). Gates phase 11's; host syncs per substep against the
    Euler substep's; 64 envs on the card against the CPU; one substep
    twice bit for bit; the LU timed per call; env-steps/s in turns; peak
    memory."""
    import torch
    import newton_tpu_torch as nt
    out = {}
    for integ in ("implicitfast", "implicit"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        model, pipe, euler = build_humanoid(dev)
        solver = nt.SolverMuJoCo(model, iterations=ITERS, integrator=integ)
        sample = ctrl_sampler(model, dev, seed=50)
        state = humanoid_reset(model, dev, seed=51)
        state = run_frames(model, pipe, solver, state, sample,
                           HUMANOID_WARMUP, True)
        touched = torch.zeros(HUMANOID_W, dtype=torch.bool, device=dev)
        reset_robot_launches()
        t0 = time.perf_counter()
        state = run_frames(model, pipe, solver, state, sample, FRAMES, True,
                           touched)
        elapsed = time.perf_counter() - t0
        n_sub = FRAMES * SUBSTEPS
        launches = gen_launches()
        want = (n_sub if integ == "implicitfast" else 0, n_sub, 0)
        if launches != want:
            raise AssertionError(f"humanoid {integ}: launches {launches}, "
                                 f"want {want}")
        zmin = check_state(state, f"humanoid {integ}", z_min=0.3)
        untouched = int((~touched).sum())
        if untouched > HUMANOID_W // 100:
            raise AssertionError(f"humanoid {integ}: {untouched} envs "
                                 "without an active contact in the window")
        ctl = batched_control(model, sample(HUMANOID_W))
        contacts = pipe.collide(state)
        rec = {}
        _, syncs = count_syncs(lambda: solver.step_batched(
            state, None, ctl, contacts, DT, record=rec))
        _, syncs_euler = count_syncs(lambda: euler.step_batched(
            state, None, ctl, contacts, DT))
        if syncs > syncs_euler:
            raise AssertionError(f"humanoid {integ}: {syncs} host syncs per "
                                 f"substep, Euler {syncs_euler}")
        r = dict(envs=HUMANOID_W, substeps=n_sub, launches=launches,
                 root_z_min=zmin, envs_untouched_in_window=untouched,
                 host_syncs_per_substep=syncs,
                 host_syncs_euler=syncs_euler,
                 main_env_steps_per_s=n_sub * HUMANOID_W / elapsed)
        if integ == "implicitfast":
            a = solver.step_batched(state, None, ctl, contacts, DT)
            b = euler.step_batched(state, None, ctl, contacts, DT)
            d = max(float((getattr(a, n) - getattr(b, n)).abs().max())
                    for n in REPEAT_FIELDS_RIGID)
            if d > 1e-6:
                raise AssertionError(f"humanoid implicitfast: {d:.3g} from "
                                     "the Euler substep with D = 0")
            r["vs_euler_max_diff"] = d
            r["b1"] = b1_check(*rec["chol"], "humanoid implicitfast")
            r["b1_times"] = b1_times(*rec["chol"])
            r["b2"] = b2_record(*rec["pgs"], "humanoid implicitfast")
        else:
            Mi, rhs = rec["lu"]
            d = Mi.shape[-1]
            B = torch.cat([torch.eye(d, device=dev).expand_as(Mi),
                           rhs[..., None]], -1)
            r["lu_shape"] = tuple(B.shape)
            r["lu_ms"] = time_ms(lambda: torch.linalg.solve_ex(
                Mi, B, check_errors=False), queued=True)
            r["b2"] = b2_record(*rec["pgs"], "humanoid implicit",
                                tol=(1e-5, 1e-4, 1e-5))
            if r["b2"]["symmetric"]:
                raise AssertionError("humanoid implicit: B2 ran the "
                                     "symmetric form")
        cpu_model = build_humanoid("cpu")[0]
        cpu_solver = nt.SolverMuJoCo(cpu_model, iterations=ITERS,
                                     integrator=integ)
        r["vs_cpu"] = vs_cpu(
            lambda s, c, k: solver.step_batched(s, None, c, k, DT),
            lambda s, c, k: cpu_solver.step_batched(s, None, c, k, DT),
            slice_batched(state, PARITY_W), slice_batched(ctl, PARITY_W),
            pipe, nt.CollisionPipeline(cpu_model), f"humanoid {integ}",
            PARITY_W)
        r["repeat_max_diff"] = repeat_bits(lambda: solver.step_batched(
            state, None, ctl, contacts, DT), f"humanoid {integ}")
        r.update(batched_turns(model, pipe, solver, state, sample, 1,
                               HUMANOID_W))
        r["profile"] = profile_frame(lambda: run_frames(
            model, pipe, solver, state, sample, 1, True), SUBSTEPS)
        r["busy_share_unprofiled"] = busy_unprofiled(
            r["profile"], HUMANOID_W, r["env_steps_per_s"])
        r["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        out[integ] = r
    return out


def flat_scene_checks(make, solver_fn, solver, state, ctl, dt, label, dev,
                      pipe=None, pipe_kw=None, witness=False):
    """64 worlds of a replicated scene (``make(lib, n)`` returns the
    builder, ``make(lib, 1)`` the one-world one) on the card against the
    CPU (``solver_fn(model)`` makes the solver; with ``witness`` a world
    off tolerance is held to a float64 CPU run, see ``vs_cpu``), and one
    substep of the full state through ``solver`` twice bit for bit."""
    import newton_tpu_torch as nt
    sub = make(nt, 1)
    m_d, m_c = make(nt, PARITY_W).finalize(dev), make(
        nt, PARITY_W).finalize("cpu")
    x_d, x_c = solver_fn(m_d), solver_fn(m_c)
    p_d = p_c = None
    kw = pipe_kw or {}
    if pipe is not None:
        p_d, p_c = (nt.CollisionPipeline(m_d, **kw),
                    nt.CollisionPipeline(m_c, **kw))
    wit = None
    if witness:
        m_w = to_float64(make(nt, PARITY_W).finalize("cpu"))
        x_w = solver_fn(m_w)
        wit = (lambda s, c, k: x_w.step(s, None, c, k, dt),
               None if pipe is None else nt.CollisionPipeline(m_w, **kw))
    s_d, c_d = slice_flat(state, ctl, PARITY_W, sub)
    res = vs_cpu(lambda s, c, k: x_d.step(s, None, c, k, dt),
                 lambda s, c, k: x_c.step(s, None, c, k, dt), s_d, c_d, p_d,
                 p_c, label, PARITY_W, witness=wit)

    def one():
        k = None if pipe is None else pipe.collide(state)
        return solver.step(state, None, ctl, k, dt)
    return res, repeat_bits(one, label)


def phase_tendons(dev):
    """Spatial tendons: example_tendon_finger.py's MJCF replicated x 4096
    under SolverMuJoCo(iterations=8), dt 1/240, 4 substeps per frame, the
    example's ctrl schedule (-6 until 1.5 s, then 0) for 3 s, under euler
    and implicitfast, the substep replayed from one CUDA graph (the
    replays' rate is reported as replay_env_steps_per_s); finite; the pip
    flexes past 0.3 rad during the pull in every world; |q| < 1.0 after
    2.5 s (the example's test_final); then FINGER_EAGER_FRAMES eager
    frames with the counts reset before them: one B1 (d = 2) a substep,
    counted, and main_env_steps_per_s; 64 worlds on the card against the
    CPU; one substep twice bit for bit; env-steps/s in turns; peak
    memory."""
    import torch
    import newton_tpu_torch as nt

    def make(lib, n):
        return mjcf_scene(lib, FINGER_MJCF, n)
    out = {}
    for integ in ("euler", "implicitfast"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        model = make(nt, FINGER_W).finalize(dev)

        def solver_fn(m, integ=integ):
            return nt.SolverMuJoCo(m, iterations=ITERS, integrator=integ)
        solver = solver_fn(model)
        state = nt.eval_fk(model, model.joint_q0, model.joint_qd0,
                           model.state())
        ctl = model.control()
        ctl.custom["mjc:ctrl"] = torch.full((FINGER_W,), -6.0, device=dev)
        fields = ("body_q", "body_qd", "joint_q", "joint_qd") + tuple(
            state.custom)
        static, replay = graphed_steps(
            lambda s: solver.step(s, None, ctl, None, DT), state, SUBSTEPS,
            fields)
        pip_max = torch.zeros(FINGER_W, device=dev)
        t0 = time.perf_counter()
        for f in range(FINGER_FRAMES):
            pull = -6.0 if f * SUBSTEPS * DT < FINGER_PULL_S else 0.0
            ctl.custom["mjc:ctrl"].fill_(pull)
            replay(SUBSTEPS)
            pip_max = torch.maximum(pip_max, static.joint_q.view(
                FINGER_W, 2)[:, 1])
        torch.cuda.synchronize()
        replay_s = time.perf_counter() - t0
        state = static
        n_replay = FINGER_FRAMES * SUBSTEPS
        q = state.joint_q.view(FINGER_W, 2)
        g = dict(pip_flex_min=float(pip_max.min()),
                 q_abs_max_end=float(q.abs().max()))
        if not (bool(torch.isfinite(state.joint_q).all())
                and g["pip_flex_min"] > 0.3 and g["q_abs_max_end"] < 1.0):
            raise AssertionError(f"finger {integ}: gates fail {g}")
        n_sub = FINGER_EAGER_FRAMES * SUBSTEPS
        reset_robot_launches()
        t0 = time.perf_counter()
        for _ in range(n_sub):
            state = solver.step(state, None, ctl, None, DT)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = gen_launches()
        if launches != (n_sub, 0, 0):
            raise AssertionError(f"finger {integ}: launches {launches}")
        if not bool(torch.isfinite(state.joint_q).all()):
            raise AssertionError(f"finger {integ}: eager frames not finite")
        ctl.custom["mjc:ctrl"] = torch.full((FINGER_W,), -6.0, device=dev)
        rec = {}
        solver.step(state, None, ctl, None, DT, record=rec)
        vs, rep = flat_scene_checks(make, solver_fn, solver, state,
                                    ctl, DT,
                                    f"finger {integ}", dev)
        out[integ] = dict(
            worlds=FINGER_W, substeps=n_sub, launches=launches, gates=g,
            main_env_steps_per_s=n_sub * FINGER_W / elapsed,
            replay_substeps=n_replay,
            replay_env_steps_per_s=n_replay * FINGER_W / replay_s,
            b1=b1_check(*rec["chol"], f"finger {integ}"),
            b1_times=b1_times(*rec["chol"]), vs_cpu=vs,
            repeat_max_diff=rep,
            **flat_rates(solver, state, ctl, 8, FINGER_W, DT),
            peak_memory_bytes=torch.cuda.max_memory_allocated())
    return out


def phase_muscles(dev):
    """Actuators and muscles: newton_tpu_torch/assets/muscle_arm.xml (a
    test scene: muscles on spatial tendons over a wrap cylinder, a filter
    <general>, <cylinder>, <intvelocity> and <damper>) replicated x 4096
    under SolverMuJoCo, Euler then implicitfast, 150 steps of 2 ms; half
    the worlds with full flexor ctrl, half with none: one B1 (d = 2) per
    substep; finite; the muscles' activations in [0, 1]; the flexed
    worlds' elbow past the idle worlds' by 0.2 rad; 64 worlds on the card
    against the CPU, a substep twice bit for bit, env-steps/s in turns.
    Then SolverSemiImplicit's waypoint muscles, tests/test_solvers.py:140's
    pair x 4096, 200 steps of 1 ms: zero activation holds the bodies to
    1e-6, full activation closes the gap below 0.9 about the midpoint
    (within 1e-5)."""
    import torch
    import newton_tpu_torch as nt
    arm_path = os.path.join(nt.ASSET_DIR, MUSCLE_ARM)

    def make(lib, n):
        r = lib.ModelBuilder()
        r.add_mjcf(arm_path)
        return replicated(lib, r, n)
    out = {}
    for integ in ("euler", "implicitfast"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = make(nt, ARM_W).finalize(dev)

        def solver_fn(m, integ=integ):
            return nt.SolverMuJoCo(m, iterations=ITERS, integrator=integ)
        solver = solver_fn(model)
        setup_s = time.perf_counter() - t0
        state = nt.eval_fk(model, model.joint_q0, model.joint_qd0,
                           model.state())
        ctl = model.control()
        A = model.structure.mjc_actuation.n // ARM_W
        ctrl = torch.zeros(ARM_W, A, device=dev)
        ctrl[ARM_W // 2:, 0] = 1.0                     # the flexor
        ctl.custom["mjc:ctrl"] = ctrl.reshape(-1)
        reset_robot_launches()
        t0 = time.perf_counter()
        for _ in range(ARM_STEPS):
            state = solver.step(state, None, ctl, None, ARM_DT)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = gen_launches()
        if launches != (ARM_STEPS, 0, 0):
            raise AssertionError(f"muscle arm {integ}: launches {launches}")
        act = state.custom["mjc:act"].view(ARM_W, A)[:, :2]
        q = state.joint_q.view(ARM_W, 2)
        g = dict(act_min=float(act.min()), act_max=float(act.max()),
                 elbow_flexed_min=float(q[ARM_W // 2:, 1].min()),
                 elbow_idle_max=float(q[:ARM_W // 2, 1].max()))
        if not (bool(torch.isfinite(state.joint_q).all())
                and g["act_min"] >= 0.0 and g["act_max"] <= 1.0
                and g["elbow_flexed_min"] > g["elbow_idle_max"] + 0.2):
            raise AssertionError(f"muscle arm {integ}: gates fail {g}")
        rec = {}
        solver.step(state, None, ctl, None, ARM_DT, record=rec)
        vs, rep = flat_scene_checks(make, solver_fn, solver, state,
                                    ctl, ARM_DT,
                                    f"muscle arm {integ}", dev)
        out["arm_" + integ] = dict(
            worlds=ARM_W, setup_s=setup_s, substeps=ARM_STEPS,
            launches=launches, gates=g,
            main_env_steps_per_s=ARM_STEPS * ARM_W / elapsed,
            b1=b1_check(*rec["chol"], f"muscle arm {integ}"),
            b1_times=b1_times(*rec["chol"]), vs_cpu=vs, repeat_max_diff=rep,
            **flat_rates(solver, state, ctl, 10, ARM_W, ARM_DT),
            peak_memory_bytes=torch.cuda.max_memory_allocated())
    # SolverSemiImplicit's waypoint muscles
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = muscle_pair_scene(nt, PAIR_W).finalize(dev)
    solver = nt.SolverSemiImplicit(model)
    res = {}
    for a in (0.0, 1.0):
        ctl = model.control()
        ctl.muscle_activations = torch.full((PAIR_W,), a, device=dev)
        state = model.state()
        t0 = time.perf_counter()
        for _ in range(PAIR_STEPS):
            state = solver.step(state, None, ctl, None, 1e-3)
        torch.cuda.synchronize()
        res[a] = (state, PAIR_STEPS * PAIR_W / (time.perf_counter() - t0))
    bq0, bq1 = res[0.0][0].body_q, res[1.0][0].body_q.view(PAIR_W, 2, 7)
    gap = torch.linalg.vector_norm(bq1[:, 1, :3] - bq1[:, 0, :3], dim=-1)
    mid = 0.5 * (bq1[:, 0, 0] + bq1[:, 1, 0])
    g = dict(hold_err=float((bq0 - model.body_q).abs().max()),
             gap_max=float(gap.max()),
             mid_err=float((mid - 0.5).abs().max()))
    if not (g["hold_err"] < 1e-6 and g["gap_max"] < 0.9
            and g["mid_err"] < 1e-5):
        raise AssertionError(f"muscle pair: gates fail {g}")
    ctl = model.control()
    ctl.muscle_activations = torch.ones(PAIR_W, device=dev)
    rep = repeat_bits(lambda: solver.step(res[1.0][0], None, ctl, None,
                                          1e-3), "muscle pair")
    out["semi_implicit_pair"] = dict(
        worlds=PAIR_W, steps=PAIR_STEPS, gates=g, repeat_max_diff=rep,
        env_steps_per_s=res[1.0][1],
        peak_memory_bytes=torch.cuda.max_memory_allocated())
    return out


def phase_kamino(dev):
    """SolverKamino: (a) example_heavy_stack_kamino.py x 1024
    (iterations=8, 60 frames of the example's 120): stack error < 0.03 in
    every world, and the PGS solver's (contact_iterations=8) more than
    twice Kamino's (tests/test_equality.py:171); (b)
    example_fourbar_kamino.py x 4096, the crank kicked to 2 rad/s, 60
    frames (the example's 120): loop drift < 2e-2 and |q0| > 0.1 in every
    world; (c) tests/test_kamino_islands.py's build_stacks(3, 2) x 1024:
    the island solve equals the dense solve within 5e-5 (q) and 5e-4 (qd)
    over 30 steps (the test runs 60). One B1 per group per substep (d =
    18, 8, 36); the factor (torch.linalg.cholesky_ex) timed per call;
    host syncs per substep; 64 worlds on the card against the CPU; a
    substep twice bit for bit; env-steps/s; peak memory."""
    import torch
    import newton_tpu_torch as nt
    out = {}
    # (a) the heavy stack
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = heavy_stack_scene(nt, STACK_W).finalize(dev)
    pipe = nt.CollisionPipeline(model)
    zs = torch.tensor(HEAVY_ZS, device=dev)
    errs, rates, ends = {}, {}, {}
    for key, solver in (("kamino", nt.SolverKamino(model, iterations=8)),
                        ("pgs", nt.SolverFeatherstone(
                            model, contact_iterations=8))):
        state = nt.eval_fk(model, model.joint_q0, model.joint_qd0,
                           model.state())
        ctl = model.control()
        reset_robot_launches()
        n_sub = STACK_FRAMES * SUBSTEPS
        t0 = time.perf_counter()
        state = run_steps(solver, state, ctl, n_sub, DT, True, pipe=pipe)
        rates[key] = n_sub * STACK_W / (time.perf_counter() - t0)
        if key == "kamino":
            launches = gen_launches()
            if launches != (n_sub, 0, 0):
                raise AssertionError(f"heavy stack: launches {launches}")
            kam = solver
        errs[key] = (state.body_q.view(STACK_W, 3, 7)[..., 2] - zs).abs()             .amax(1)
        ends[key] = state
    g = dict(kamino_err_max=float(errs["kamino"].max()),
             pgs_over_kamino_min=float((errs["pgs"] / errs["kamino"]).min()))
    if not (g["kamino_err_max"] < 0.03 and g["pgs_over_kamino_min"] > 2.0):
        raise AssertionError(f"heavy stack: gates fail {g}")
    state, ctl = ends["kamino"], model.control()
    contacts = pipe.collide(state)
    rec = {}
    _, syncs = count_syncs(lambda: kam.step(state, None, ctl, contacts, DT,
                                            record=rec))
    K = rec["admm_factor"]
    r = dict(worlds=STACK_W, substeps=n_sub, launches=launches, gates=g,
             host_syncs_per_substep=syncs, factor_shape=tuple(K.shape),
             factor_ms=time_ms(lambda: torch.linalg.cholesky_ex(
                 K, check_errors=False), queued=True),
             b1=b1_check(*rec["chol"], "heavy stack"),
             b1_times=b1_times(*rec["chol"]),
             main_env_steps_per_s=rates["kamino"],
             pgs_env_steps_per_s=rates["pgs"],
             **flat_rates(kam, state, ctl, 8, STACK_W, DT, pipe=pipe))

    r["vs_cpu"], r["repeat_max_diff"] = flat_scene_checks(
        heavy_stack_scene, lambda m: nt.SolverKamino(m, iterations=8), kam,
        state, ctl, DT, "heavy stack", dev, pipe=pipe)
    r["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    out["heavy_stack"] = r
    # (b) the four-bar
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = fourbar_scene(nt, FOURBAR_W).finalize(dev)
    solver = nt.SolverKamino(model)
    qd0 = model.joint_qd0.clone().view(FOURBAR_W, -1)
    qd0[:, 0] = 2.0
    state = nt.eval_fk(model, model.joint_q0, qd0.reshape(-1), model.state())
    ctl = model.control()
    reset_robot_launches()
    n_sub = FOURBAR_FRAMES * SUBSTEPS
    t0 = time.perf_counter()
    state = run_steps(solver, state, ctl, n_sub, DT, True)
    elapsed = time.perf_counter() - t0
    launches = gen_launches()
    if launches != (n_sub, 0, n_sub):
        raise AssertionError(f"four-bar: launches {launches}")
    drift = fourbar_drift(state.body_q.view(FOURBAR_W, 3, 7))
    q0 = state.joint_q.view(FOURBAR_W, -1)[:, 0]
    g = dict(drift_max=float(drift.max()), q0_abs_min=float(q0.abs().min()))
    if not (g["drift_max"] < 2e-2 and g["q0_abs_min"] > 0.1):
        raise AssertionError(f"four-bar: gates fail {g}")
    rec = {}
    solver.step(state, None, ctl, None, DT, record=rec)

    vs, rep = flat_scene_checks(fourbar_scene, nt.SolverKamino, solver,
                                state, ctl, DT, "four-bar", dev)
    out["fourbar"] = dict(
        worlds=FOURBAR_W, substeps=n_sub, launches=launches, gates=g,
        env_steps_per_s=n_sub * FOURBAR_W / elapsed,
        b1=b1_check(*rec["chol"], "four-bar"),
        b1_times=b1_times(*rec["chol"]), vs_cpu=vs, repeat_max_diff=rep,
        peak_memory_bytes=torch.cuda.max_memory_allocated())
    # (c) islands against the dense factor
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = stacks_scene(nt, n=ISLAND_W).finalize(dev)
    pipe = nt.CollisionPipeline(model)
    ends = {}
    for key, isl in (("islands", True), ("dense", False)):
        solver = nt.SolverKamino(model, iterations=16, use_islands=isl,
                                 contact_cap=0)
        if (solver.groups[0].tables.islands is None) == isl:
            raise AssertionError(f"stacks: the {key} path did not engage")
        state = solver.init_state(nt.eval_fk(
            model, model.joint_q0, model.joint_qd0, model.state()))
        reset_robot_launches()
        t0 = time.perf_counter()
        state = run_steps(solver, state, model.control(), ISLAND_STEPS, DT,
                          True, pipe=pipe)
        rates[key] = ISLAND_STEPS * ISLAND_W / (time.perf_counter() - t0)
        if gen_launches() != (ISLAND_STEPS, 0, 0):
            raise AssertionError(f"stacks {key}: launches {gen_launches()}")
        ends[key] = state
        if isl:
            rec = {}
            solver.step(state, None, None, pipe.collide(state), DT,
                        record=rec)
            K = rec["admm_factor"]
            isl_factor = dict(shape=tuple(K.shape), ms=time_ms(
                lambda: torch.linalg.cholesky_ex(K, check_errors=False),
                queued=True), b1_times=b1_times(*rec["chol"]),
                b1=b1_check(*rec["chol"], "stacks"))
    e_q = float((ends["islands"].body_q - ends["dense"].body_q).abs().max())
    e_qd = float((ends["islands"].body_qd - ends["dense"].body_qd).abs()
                 .max())
    if not (e_q < 5e-5 and e_qd < 5e-4):
        raise AssertionError(f"stacks: islands vs dense q {e_q:.3g}, qd "
                             f"{e_qd:.3g}")
    out["islands"] = dict(worlds=ISLAND_W, steps=ISLAND_STEPS,
                          island_vs_dense=(e_q, e_qd), **isl_factor,
                          env_steps_per_s_islands=rates["islands"],
                          env_steps_per_s_dense=rates["dense"],
                          peak_memory_bytes=torch.cuda.max_memory_allocated())
    return out


# ---------------------------------------------------------------------------
# phases 37-44: bodies outside the articulations, mounted articulations,
# contact-force reports, and the rest of SolverXPBD
# ---------------------------------------------------------------------------
CONVEYOR_W = 4096
BELT_SPEED = 0.6                      # example_basic_conveyor_forces.py
CONVEYOR_ITERS = 16
CONVEYOR_WARMUP = 8                   # frames: the crates reach belt speed
MOUNT_W = 4096
MOUNT_WARMUP = 2
TOWER_W = 4096
TOWER_ITERS = 40                      # tests/test_stacking.py:166
TOWER_SETTLE = 200                    # substeps, tests/test_stacking.py:175
TOWER_H = 0.1
XPBD_CLOTH_ITERS = 4
XPBD_CPU_DIM = 20                     # the card against the CPU, 4 substeps
LAYER_DIM = 70                        # 2 x 71^2 = 10,082 particles
LAYER_FRAMES = 10                     # tests/test_cloth_solvers.py:115
GRAN_DIMS = (64, 64, 8)               # 32,768: bench.py --mode mpm's count
GRAN_WARMUP = 50
GRAN_ITERS = 3
GRAN_MAX_PER_CELL = 8                 # the hash grid's budget (default 4)
CABLE_W = 1024
CABLE_WARMUP = 1
PILE_FRAMES = 4                       # timed: its substep is ~9,000 ops
CABLE_ITERS = 6
SAG_W = 1024                          # three cantilevers per world
SAG_DT = 1.0 / 960.0                  # tests/test_cable.py:59
SAG_STEPS = 1500                      # tests/test_cable.py:69
SAG_KE = (0.5, 5.0, 500.0)
DAHL_W = 1024
DAHL_DT = 1.0 / 480.0                 # example_cable_dahl_hysteresis.py
DAHL_SUBSTEPS = 8
DAHL_FRAMES = 60                      # 1 s: forward 0.5 s, back 0.5 s
DAHL_TIMED = 2                        # frames of the eager timed window
HOLD_FRAMES = 30                      # tests/test_dahl_friction.py:69: 60
HOLD_PUSH = 15.0


def conveyor_scene(lib, n):
    """example_basic_conveyor_forces.py: a kinematic belt (a jointless box
    moving at BELT_SPEED along x) and two crates on free joints (one
    articulation), mu 0.9, replicated to n worlds."""
    import numpy as np
    sub = lib.ModelBuilder(gravity=-9.81)
    cfg = sub.default_shape_cfg.copy()
    cfg.mu = 0.9
    belt = sub.add_body(xform=[0.0, 0.0, 0.05, 0, 0, 0, 1],
                        qd=np.array([BELT_SPEED, 0, 0, 0, 0, 0]),
                        kinematic=True, key="belt")
    sub.add_shape_box(belt, hx=2.0, hy=0.5, hz=0.05, cfg=cfg, key="belt_top")
    for i in range(2):
        bb = sub.add_body(xform=[-1.0 + 0.5 * i, 0.0, 0.2, 0, 0, 0, 1],
                          key=f"crate_{i}")
        sub.add_shape_box(bb, hx=0.1, hy=0.1, hz=0.1, cfg=cfg,
                          key=f"crate_shape_{i}")
        sub.add_joint_free(bb, key=f"crate_free_{i}")
    return replicated(lib, sub, n)


def mounted_scene(lib, n, ground=True):
    """A two-link arm (revolute joints about y, capsules) mounted on a free
    box base: the arm is its own articulation whose root joint hangs from
    the base's body; on a ground plane unless ``ground`` is False;
    replicated to n worlds."""
    sub = lib.ModelBuilder(gravity=-9.81)
    base = sub.add_body(xform=[0.0, 0.0, 0.5, 0, 0, 0, 1], key="base")
    sub.add_shape_box(base, hx=0.3, hy=0.2, hz=0.1)
    sub.add_joint_free(base)
    sub.add_articulation()
    l1 = sub.add_body(xform=[0.2, 0.0, 0.85, 0, 0, 0, 1], key="upper")
    sub.add_shape_capsule(l1, radius=0.04, half_height=0.2)
    sub.add_joint_revolute(base, l1, xform_p=[0.2, 0, 0.1, 0, 0, 0, 1],
                           xform_c=[0, 0, -0.25, 0, 0, 0, 1], axis=(0, 1, 0))
    l2 = sub.add_body(xform=[0.2, 0.0, 1.35, 0, 0, 0, 1], key="lower")
    sub.add_shape_capsule(l2, radius=0.04, half_height=0.2)
    sub.add_joint_revolute(l1, l2, xform_p=[0, 0, 0.25, 0, 0, 0, 1],
                           xform_c=[0, 0, -0.25, 0, 0, 0, 1], axis=(0, 1, 0))
    if ground:
        sub.add_ground_plane()
    return replicated(lib, sub, n)


def tower_scene(lib, n):
    """tests/test_stacking.py:27's build_tower(2, jitter=False): two boxes
    of half-extent 0.1 stacked on a ground plane, mu 0.8, on free joints
    (one articulation); replicated to n worlds."""
    sub = lib.ModelBuilder(gravity=-9.81)
    cfg = sub.default_shape_cfg.copy()
    cfg.mu = 0.8
    for i in range(2):
        z = TOWER_H + 2 * TOWER_H * 1.002 * i
        bb = sub.add_body(xform=[0.0, 0.0, z, 0.0, 0.0, 0.0, 1.0],
                          key=f"b{i}")
        sub.add_shape_box(bb, hx=TOWER_H, hy=TOWER_H, hz=TOWER_H, cfg=cfg)
        sub.add_joint_free(bb)
    sub.add_ground_plane()
    return replicated(lib, sub, n)


def layers_scene(lib, dim=None, radius=0.03, gap=0.004):
    """tests/test_cloth_solvers.py:58's two overlapping cloth layers
    (cell 0.1, radius 0.03, gap 0.004, no gravity), dim x dim cells each
    (LAYER_DIM by default)."""
    dim = LAYER_DIM if dim is None else dim
    b = lib.ModelBuilder()
    b.gravity = 0.0
    for z in (1.0, 1.0 + gap):
        b.add_cloth_grid(pos=(0, 0, z), dim_x=dim, dim_y=dim, cell_x=0.1,
                         cell_y=0.1, mass=1.0, radius=radius, tri_ke=500.0,
                         edge_ke=2.0)
    return b


def granular_scene(lib, dims=None):
    """tests/test_cloth_solvers.py:229's particle grid (cell 0.11, mass
    0.1, radius 0.05 from z = 0.3) at dims[0] x dims[1] x dims[2]
    (GRAN_DIMS by default) on a ground plane."""
    dims = GRAN_DIMS if dims is None else dims
    b = lib.ModelBuilder()
    b.add_particle_grid(pos=(-0.055 * dims[0], -0.055 * dims[1], 0.3),
                        dim_x=dims[0], dim_y=dims[1], dim_z=dims[2],
                        cell_x=0.11, cell_y=0.11, cell_z=0.11, mass=0.1,
                        radius=0.05)
    b.add_ground_plane()
    return b


def cable_pile_scene(lib, n):
    """example_cable_pile.py: five free cable rods of six segments (rod
    graphs, radius 0.03, bend_ke 20, twist_ke 10) dropped from 0.6-2.0 m
    in random directions (seed 3) onto a ground plane; n worlds. Its 440
    candidate pairs a world exceed the pipeline's dynamic-mode threshold
    (8 per shape): ``CollisionPipeline(model)`` runs dynamic-pair mode, as
    the example's does."""
    import numpy as np
    sub = lib.ModelBuilder()
    rng = np.random.default_rng(3)
    n_seg = 6
    for k in range(5):
        a = rng.uniform(0, 2 * np.pi)
        x0 = np.array([rng.uniform(-0.2, 0.2), rng.uniform(-0.2, 0.2),
                       0.6 + 0.35 * k])
        d = np.array([np.cos(a), np.sin(a), 0.0]) * 0.8
        pts = [x0 + d * (i / n_seg) for i in range(n_seg + 1)]
        sub.add_rod_graph(pts, [(i, i + 1) for i in range(n_seg)],
                          radius=0.03, density=800.0, joint="cable",
                          bend_ke=20.0, bend_kd=0.5, twist_ke=10.0,
                          twist_kd=0.2, key=f"rod{k}")
    sub.add_ground_plane()
    return replicated(lib, sub, n)


def sag_scene(lib, n):
    """tests/test_cable.py:32's cantilever (6 cable segments from
    (0, 0, 1) to (0.6, 0, 1), fixed root, stretch_ke 2e4) at each bend
    stiffness of SAG_KE, side by side in y in one world; n worlds. Returns
    (builder, the tip bodies of one world)."""
    sub = lib.ModelBuilder(gravity=-9.81)
    tips = []
    for k, ke in enumerate(SAG_KE):
        y = 0.5 * k
        bodies = sub.add_rod([0, y, 1.0], [0.6, y, 1.0], segments=6,
                             radius=0.01, joint="cable", bend_ke=ke,
                             bend_kd=0.4, stretch_ke=2.0e4, stretch_kd=1.0,
                             root_joint="fixed")
        tips.append(bodies[-1])
    return replicated(lib, sub, n), tips


def dahl_scene(lib, n):
    """example_cable_dahl_hysteresis.py: a ten-segment cable on the ground
    hitched by a cable joint to a kinematic handle (0.4 m/s along x),
    mu 0.6; n worlds. Returns (builder, handle, tail) of one world."""
    import numpy as np
    from newton_tpu_torch.core.host_math import np_transform
    sub = lib.ModelBuilder(gravity=-9.81)
    cfg = sub.default_shape_cfg.copy()
    cfg.mu = 0.6
    handle = sub.add_body(xform=np_transform(np.array([-0.05, 0.0, 0.035])),
                          qd=np.array([0.4, 0, 0, 0, 0, 0]), kinematic=True,
                          key="handle")
    sub.add_shape_box(handle, hx=0.03, hy=0.03, hz=0.03, cfg=cfg)
    bodies = sub.add_rod([0.0, 0.0, 0.03], [0.8, 0.0, 0.03], segments=10,
                         radius=0.025, joint="cable", bend_ke=2.0,
                         bend_kd=0.05, stretch_ke=2.0e4, stretch_kd=1.0,
                         root_joint="free", key="cable")
    q_tan = np.array([0.0, np.sin(np.pi / 4), 0.0, np.cos(np.pi / 4)])
    sub.add_joint_cable(handle, bodies[0],
                        xform_p=np_transform(np.array([0.03, 0.0, 0.0]),
                                             q_tan),
                        xform_c=np_transform(np.array([0.0, 0.0, -0.04])),
                        stretch_stiffness=2.0e4, stretch_damping=1.0,
                        bend_stiffness=1.0, bend_damping=0.05, key="hitch")
    sub.add_ground_plane(cfg=cfg)
    return replicated(lib, sub, n), handle, bodies[-1]


def dahl_box_scene(lib, n):
    """tests/test_dahl_friction.py:20: a 0.2 m box (8 kg) on the ground on
    a free joint, mu 0.5; n worlds."""
    sub = lib.ModelBuilder()
    body = sub.add_body(xform=[0, 0, 0.1, 0, 0, 0, 1])
    cfg = sub.default_shape_cfg.copy()
    cfg.mu = 0.5
    sub.add_shape_box(body, hx=0.1, hy=0.1, hz=0.1, cfg=cfg)
    sub.add_joint_free(body)
    sub.add_ground_plane(cfg=cfg)
    return replicated(lib, sub, n)


def path_metrics(frame_fn, substep_fn, units, rate):
    """One profiled substep (device ms and operations of the substep, busy
    share profiled and of an unprofiled substep at ``rate``
    units-steps/s), the host syncs of one substep, and the peak device
    memory so far. ``frame_fn`` (a frame of SUBSTEPS substeps) is not
    run: profiling one substep keeps the profiler's cost down."""
    import torch
    prof = profile_frame(substep_fn, 1)
    _, syncs = count_syncs(substep_fn)
    return dict(profile=prof, busy_share_unprofiled=busy_unprofiled(
        prof, units, rate), host_syncs_per_substep=syncs,
        sync_sites=list(SYNC_SITES),
        peak_memory_bytes=torch.cuda.max_memory_allocated())


def repeat_fields(step, fields, label):
    """Two runs of one substep from the same inputs equal bit for bit in
    ``fields`` (State fields, or custom keys)."""
    import torch
    a, b = step(), step()
    for n in fields:
        ca, cb = getattr(a, "custom", {}), getattr(b, "custom", {})
        x = ca[n] if n in ca else getattr(a, n)
        y = cb[n] if n in cb else getattr(b, n)
        if not torch.equal(x, y):
            raise AssertionError(f"{label}: two runs of a substep differ in "
                                 f"{n}")
    return True


def xpbd_vs_cpu(dev, builder, make_solver, state, substeps, dt, label,
                pipe=False, tol=None, pipe_kw=None, ties=False, units=None,
                max_left_out=0):
    """``substeps`` XPBD substeps on the card against the same on the CPU
    from one state (the model finalized on each side; collide with
    ``CollisionPipeline(model, **pipe_kw)``, static mode unless named):
    particle_q and body_q within 2e-4, particle_qd and body_qd within 5e-3
    (joint_q 2e-4, joint_qd 5e-3), every world compared, the errors
    returned. With ``ties`` (the rigid scenes of phases 45-46), a world
    off tolerance is held instead to the same substeps in float64 on the
    CPU (the model and state cast): on a tie of the contact geometry (a
    flat face on a flat face, whose contact points the last bits decide)
    the float32 CPU run parts from the float64 one while the card keeps
    to it. The worlds so held and the float32 CPU's gap to the float64 run
    are returned; a world that agrees with neither run fails, unless
    ``units`` splits the state into that many units (the bodies of a
    one-world pile, each with its free joint) and at most
    ``max_left_out`` of them agree with neither, each with a second
    witness that the reference itself moves there: the float32 CPU run is
    off tolerance against the float64 one on that unit too, and the card
    is at most twice as far from the float64 run as the float32 CPU (in
    units of the tolerance). Those are counted and their gaps returned."""
    import torch
    import newton_tpu_torch as nt
    tol = tol or {"particle_q": 2e-4, "particle_qd": 5e-3, "body_q": 2e-4,
                  "body_qd": 5e-3, "joint_q": 2e-4, "joint_qd": 5e-3}
    f64 = to_float64
    sides = {}
    for side, d in (("card", dev), ("cpu", "cpu")) + (
            (("float64", "cpu"),) if ties else ()):
        m = builder.finalize(d)
        m = f64(m) if side == "float64" else m
        p = nt.CollisionPipeline(m, **(pipe_kw or {"mode": "static"})) \
            if pipe else None
        sides[side] = (make_solver(m), p)

    def run(side, s):
        solver, p = sides[side]
        if hasattr(solver, "init_state"):
            s = solver.init_state(s)
        for _ in range(substeps):
            s = solver.step(s, None, None, None if p is None
                            else p.collide(s), dt)
        return s
    n = (units or max(builder.world_count, 1)) if ties else 1

    def per_world(a, b):
        """((n,) every field of a within tolerance of b in that world,
        {field: max abs error}, (n,) the largest error over the
        tolerance)."""
        ratio, err = torch.zeros(n, dtype=torch.float64), {}
        for k, t in tol.items():
            x, y = getattr(a, k), getattr(b, k)
            if not x.numel():
                continue
            x = x.cpu().double().reshape(n, -1)
            y = y.double().reshape(n, -1)
            diff = (x - y).abs()
            ratio = torch.maximum(ratio, (diff / (t + t * y.abs())).amax(1))
            err[k] = float(diff.max())
        return ratio <= 1.0, err, ratio
    card = run("card", state.to(dev))
    cpu = run("cpu", state.to("cpu"))
    ok, err, _ = per_world(card, cpu)
    if bool(ok.all()):
        return err
    if not ties:
        raise AssertionError(f"{label}: card vs CPU off tolerance {err}")
    exact = run("float64", f64(state.to("cpu")))
    ok64, err64, r_card = per_world(card, exact)
    _, err32, r_cpu = per_world(cpu, exact)
    out = ~ok & ~ok64
    left_out = int(out.sum())
    gaps = [(int(i), float(r_card[i]), float(r_cpu[i]))
            for i in torch.nonzero(out).flatten()]
    if left_out > max_left_out or any(
            rc <= 1.0 or ra > 2.0 * rc for _, ra, rc in gaps):
        raise AssertionError(
            f"{label}: {left_out} of {n} worlds off "
            f"tolerance against the CPU in float32 {err} and in float64 "
            f"{err64} (float32 vs float64 on the CPU {err32}; per unit "
            f"(unit, card, CPU) gap to float64 over the tolerance {gaps})")
    return dict(err, worlds_held_to_float64=int((~ok).sum()),
                units_left_out=left_out, card_vs_float64=err64,
                cpu_vs_float64=err32, left_out_gaps=gaps)


def phase_conveyor(dev):
    """example_basic_conveyor_forces.py x 4096 (replicate): the kinematic
    belt at 0.6 m/s under two crates, SolverMuJoCo(iterations=16,
    warm_start=False), step_with_contacts every substep, dt 1/240, 4
    substeps: one group of d = 12 (both crates), 48 entries per world (16
    belt-crate entries per crate with the belt as the moving support, 16
    crate-crate) compacted to 32: one B1 (d = 12) and one B2 ((32, 0, 12),
    w_other 0 with a non-zero constant row) per substep. Warm-up frames,
    then 10 frames; gates: each crate moving at the belt's speed within 5%,
    the summed normal force of each world within 10% of both crates'
    weight, the drag force finite; a kernel vs plain substep (2e-4 /
    5e-3); 64 worlds on the card against the CPU; two runs of a substep
    and its force report bit-equal; device ms and operations per frame,
    busy share, host syncs per substep, peak memory."""
    import torch
    import newton_tpu_torch as nt
    from newton_tpu_torch.solvers.generalized import linalg, pgs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = conveyor_scene(nt, CONVEYOR_W).finalize(dev)
    pipe = nt.CollisionPipeline(model)

    def solver_fn(m):
        return nt.SolverMuJoCo(m, iterations=CONVEYOR_ITERS,
                               warm_start=False)
    solver = solver_fn(model)
    state = model.state()
    ctl = model.control()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    grp = solver.groups[0]
    if [(g.g.n, g.g.d) for g in solver.groups] != [(CONVEYOR_W, 12)] \
            or grp.plan.c != 48 or grp.tables.cap != 32 \
            or grp.tables.other is None:
        raise AssertionError("conveyor: expected one group of d = 12 with 48 "
                             "entries (the belt on their other side) "
                             "compacted to 32")

    def sub_step(s):
        return solver.step_with_contacts(s, None, ctl, pipe.collide(s), DT)
    for _ in range(CONVEYOR_WARMUP * SUBSTEPS):
        state, _ = sub_step(state)
    torch.cuda.synchronize()
    reset_robot_launches()
    n_sub = FRAMES * SUBSTEPS
    t0 = time.perf_counter()
    for _ in range(n_sub):
        state, rep = sub_step(state)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = gen_launches()
    if launches != (n_sub, n_sub, 0):
        raise AssertionError(f"conveyor: launches {launches} in {n_sub} "
                             "substeps")
    check_flat(state, CONVEYOR_W, "conveyor")
    C1 = model.structure.rigid_contact_max // CONVEYOR_W
    f = rep.rigid_contact_force.view(CONVEYOR_W, C1, 3)
    on = rep.rigid_contact_mask.view(CONVEYOR_W, C1, 1)
    normal = (f[..., 2:3].abs() * on).sum((1, 2))
    drag = (f[..., 0:1] * on).sum((1, 2))
    mass = model.body_mass.view(CONVEYOR_W, 3)[:, 1:].sum(1)
    vx = state.body_qd.view(CONVEYOR_W, 3, 6)[:, 1:, 0]
    gates = dict(
        crate_speed_err_max=float((vx / BELT_SPEED - 1).abs().max()),
        normal_over_weight_err_max=float((normal / (9.81 * mass) - 1)
                                         .abs().max()),
        drag_finite=bool(torch.isfinite(drag).all()),
        drag_mean=float(drag.mean()))
    if not (gates["crate_speed_err_max"] < 0.05
            and gates["normal_over_weight_err_max"] < 0.10
            and gates["drag_finite"]):
        raise AssertionError(f"conveyor: gates fail {gates}")
    contacts = pipe.collide(state)
    errs, recs = group_paths(solver, state, ctl, contacts, DT, "conveyor")
    Mi, rhs = recs[0]["chol"]
    args, kw = recs[0]["pgs"]
    if "w_other" not in kw:
        raise AssertionError("conveyor: B2 got no w_other")
    const_rows = float((args[3][:, :3 * kw["c"]]).abs().max())
    vs, rep_bits = flat_scene_checks(conveyor_scene, solver_fn, solver,
                                     state, ctl, DT, "conveyor", dev,
                                     pipe=pipe)
    repeat_fields(lambda: sub_step(state)[1], ("rigid_contact_force",),
                  "conveyor force report")
    rate_rates, _, _ = turns(solver, state, state.clone(), ctl,
                             TURN_FRAMES * SUBSTEPS, CONVEYOR_W, DT,
                             pipe=pipe)
    rate = sum(rate_rates[True]) / 2
    metrics = path_metrics(
        lambda: [sub_step(state) for _ in range(SUBSTEPS)],
        lambda: sub_step(state), CONVEYOR_W, rate)
    return dict(worlds=CONVEYOR_W, setup_s=setup_s, substeps=n_sub,
                launches=launches, gates=gates,
                main_env_steps_per_s=n_sub * CONVEYOR_W / elapsed,
                env_steps_per_s=rate,
                plain_env_steps_per_s=sum(rate_rates[False]) / 2,
                paths=errs, vs_cpu=vs, repeat_max_diff=rep_bits,
                b1_instance=linalg.kernel_instance(12),
                b1_max_abs_err=errs["b1 group 0"][0], b1=b1_times(Mi, rhs),
                b2=b2_record(args, kw, "conveyor"),
                b2_const_row_max=const_rows,
                b2_w_other_max=float(kw["w_other"].abs().max()),
                b2_smem_bytes=pgs.smem_bytes(kw["c"], 0, 12), **metrics)


def phase_mounted(dev):
    """An articulation mounted on another's body x 4096: mounted_scene (a
    two-link arm on a free box base, ground plane), SolverMuJoCo(
    iterations=8, euler) through step, dt 1/240, 4 substeps: two groups
    (the base d = 6, the arm d = 2 carrying the base as its mount), one B1
    per group and one B2 per group with contacts per substep; 10 warm-up
    and 10 frames with finite state, unit quaternions and the base above
    the ground; a kernel vs plain substep; 64 worlds on the card against
    the CPU; two runs bit-equal; the pinned reference defect (ROADMAP
    C.24): lifted clear of the ground and released at rest, the base
    accelerates at g (m_base + m_arm) / m_base, not g, while the arm's
    joints stay at rest; device ms and operations of a substep, busy share,
    host syncs per substep, peak memory."""
    import torch
    import newton_tpu_torch as nt
    from newton_tpu_torch.solvers.generalized import linalg, pgs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = mounted_scene(nt, MOUNT_W).finalize(dev)
    pipe = nt.CollisionPipeline(model)

    def solver_fn(m):
        return nt.SolverMuJoCo(m, iterations=ITERS, integrator="euler")
    solver = solver_fn(model)
    state0 = nt.eval_fk(model, model.joint_q0, model.joint_qd0,
                        model.state())
    ctl = model.control()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    shape = [(g.g.n, g.g.d) for g in solver.groups]
    if shape != [(MOUNT_W, 6), (MOUNT_W, 2)] or solver.mount_order != [1]:
        raise AssertionError(f"mounted: groups {shape}, mounts "
                             f"{solver.mount_order}")
    n_contact_groups = sum(g.plan is not None for g in solver.groups)
    state = run_steps(solver, state0, ctl, MOUNT_WARMUP * SUBSTEPS, DT, True,
                      pipe=pipe)
    reset_robot_launches()
    n_sub = FRAMES * SUBSTEPS
    t0 = time.perf_counter()
    state = run_steps(solver, state, ctl, n_sub, DT, True, pipe=pipe)
    elapsed = time.perf_counter() - t0
    launches = gen_launches()
    if launches != (2 * n_sub, n_contact_groups * n_sub, 0):
        raise AssertionError(f"mounted: launches {launches} in {n_sub} "
                             "substeps")
    check_flat(state, MOUNT_W, "mounted")
    base_z = float(state.body_q.view(MOUNT_W, 3, 7)[:, 0, 2].min())
    if not base_z > 0.0:
        raise AssertionError(f"mounted: base below the ground ({base_z})")
    contacts = pipe.collide(state)
    errs, recs = group_paths(solver, state, ctl, contacts, DT, "mounted")
    vs, rep_bits = flat_scene_checks(mounted_scene, solver_fn, solver,
                                     state, ctl, DT, "mounted", dev,
                                     pipe=pipe)
    # C.24: lifted 10 m, released at rest, one substep without contacts
    lifted = state0.clone()
    lifted.body_q[:, 2] += 10.0
    lifted = nt.eval_ik(model, lifted)
    lifted = nt.eval_fk(model, lifted[0], torch.zeros_like(lifted[1]),
                        state0)
    one = solver.step(lifted, None, ctl, None, DT)
    m = model.body_mass.view(MOUNT_W, 3)
    a_base = one.body_qd.view(MOUNT_W, 3, 6)[:, 0, 2] / DT
    expect = -9.81 * m.sum(1) / m[:, 0]
    defect = dict(
        base_az_mean=float(a_base.mean()), expected_jax=float(expect.mean()),
        rel_err_max=float(((a_base - expect) / expect).abs().max()),
        arm_qd_abs_max=float(one.joint_qd.view(MOUNT_W, 8)[:, 6:].abs()
                             .max()))
    if not (defect["rel_err_max"] < 1e-4 and defect["arm_qd_abs_max"]
            < 1e-6):
        raise AssertionError(f"mounted: the pinned C.24 free fall moved "
                             f"{defect}")
    rate_rates, _, _ = turns(solver, state, state.clone(), ctl,
                             TURN_FRAMES * SUBSTEPS, MOUNT_W, DT, pipe=pipe)
    rate = sum(rate_rates[True]) / 2
    metrics = path_metrics(
        lambda: run_steps(solver, state, ctl, SUBSTEPS, DT, True,
                          pipe=pipe),
        lambda: solver.step(state, None, ctl, pipe.collide(state), DT),
        MOUNT_W, rate)
    times = {}
    for gi, r in recs.items():
        t = dict(b1=b1_times(*r["chol"]), d=r["chol"][0].shape[-1])
        t["b1_instance"] = linalg.kernel_instance(t["d"])
        if "pgs" in r:
            t["b2"] = b2_record(*r["pgs"], f"mounted group {gi}")
        times[gi] = t
    return dict(worlds=MOUNT_W, setup_s=setup_s, substeps=n_sub,
                groups=shape, launches=launches, base_z_min=base_z,
                main_env_steps_per_s=n_sub * MOUNT_W / elapsed,
                env_steps_per_s=rate,
                plain_env_steps_per_s=sum(rate_rates[False]) / 2,
                paths=errs, vs_cpu=vs, repeat_max_diff=rep_bits,
                defect_c24=defect, times=times, **metrics)


def phase_tower(dev):
    """tests/test_stacking.py's test_third_law_reaction x 4096: two boxes
    stacked on the ground, SolverMuJoCo(iterations=40, euler,
    warm_start=False, contact_cap=0) through step, 200 substeps of 1/240
    to settle, then 10 frames and step_with_contacts: one group of d = 12
    with 32 entries, every one solved (B2 (32, 0, 12)); gates in every
    world: the ground carries both weights and the box-box contact one
    weight, within 35%; a kernel vs plain substep; two runs of the force
    report bit-equal; device ms and operations of a substep, busy share,
    host syncs per substep, peak memory."""
    import torch
    import newton_tpu_torch as nt
    from newton_tpu_torch.geometry.types import GeoType
    from newton_tpu_torch.solvers.generalized import linalg
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = tower_scene(nt, TOWER_W).finalize(dev)
    pipe = nt.CollisionPipeline(model)
    solver = nt.SolverMuJoCo(model, iterations=TOWER_ITERS,
                             integrator="euler", warm_start=False,
                             contact_cap=0)
    state = solver.init_state(model.state())
    ctl = model.control()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    state = run_steps(solver, state, ctl, TOWER_SETTLE, DT, True, pipe=pipe)
    reset_robot_launches()
    n_sub = FRAMES * SUBSTEPS
    t0 = time.perf_counter()
    state = run_steps(solver, state, ctl, n_sub, DT, True, pipe=pipe)
    elapsed = time.perf_counter() - t0
    launches = gen_launches()
    if launches != (n_sub, n_sub, 0):
        raise AssertionError(f"tower: launches {launches}")
    check_flat(state, TOWER_W, "tower")

    def report():
        return solver.step_with_contacts(state, None, ctl,
                                         pipe.collide(state), DT)[1]
    c2 = report()
    st = model.structure
    plane = torch.as_tensor(st.shape_type == int(GeoType.PLANE), device=dev)
    s0 = c2.rigid_contact_shape0.long().clamp(min=0)
    s1 = c2.rigid_contact_shape1.long().clamp(min=0)
    gnd = c2.rigid_contact_mask & (plane[s0] | plane[s1])
    bb = c2.rigid_contact_mask & ~plane[s0] & ~plane[s1]
    C1 = st.rigid_contact_max // TOWER_W
    fz = c2.rigid_contact_force[:, 2].view(TOWER_W, C1)
    w_one = 9.81 / model.body_inv_mass.view(TOWER_W, 2)[:, 0]
    f_gnd = (fz * gnd.view(TOWER_W, C1)).sum(1).abs()
    f_bb = (fz * bb.view(TOWER_W, C1)).sum(1).abs()
    gates = dict(ground_err_max=float(((f_gnd - 2 * w_one) / (2 * w_one))
                                      .abs().max()),
                 box_box_err_max=float(((f_bb - w_one) / w_one).abs().max()))
    if not (gates["ground_err_max"] < 0.35
            and gates["box_box_err_max"] < 0.35):
        raise AssertionError(f"tower: third-law gates fail {gates}")
    contacts = pipe.collide(state)
    errs, recs = group_paths(solver, state, ctl, contacts, DT, "tower")
    repeat_fields(report, ("rigid_contact_force",), "tower force report")
    rate = n_sub * TOWER_W / elapsed
    metrics = path_metrics(
        lambda: run_steps(solver, state, ctl, SUBSTEPS, DT, True,
                          pipe=pipe), report, TOWER_W, rate)
    args, kw = recs[0]["pgs"]
    return dict(worlds=TOWER_W, setup_s=setup_s, substeps=n_sub,
                launches=launches, gates=gates, env_steps_per_s=rate,
                paths=errs, b1_instance=linalg.kernel_instance(12),
                b1_max_abs_err=errs["b1 group 0"][0],
                b1=b1_times(*recs[0]["chol"]),
                b2=b2_record(args, kw, "tower", tol=(1e-4, 1e-4, 1e-3)),
                **metrics)


def xpbd_particle_phase(dev, builder, make_solver, warmup, frames, label,
                        pipe=False, gates=None, units=None, pipe_kw=None):
    """A particle scene under SolverXPBD: setup, ``warmup`` and ``frames``
    timed frames of SUBSTEPS substeps at DT (collide each substep with
    ``pipe``: ``CollisionPipeline(model, **pipe_kw)``, static mode unless
    named), no B1-B4 launch, the gates (``gates(model, state)`` returns
    them and raises on failure), one substep twice on the card bit for
    bit, the rate in particle-steps/s, path metrics."""
    import torch
    import newton_tpu_torch as nt
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = builder.finalize(dev)
    solver = make_solver(model)
    p = nt.CollisionPipeline(model, **(pipe_kw or {"mode": "static"})) \
        if pipe else None
    state = solver.init_state(model.state())
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    reset_all_launches()
    state = cloth_run(solver, state, warmup, SUBSTEPS, DT, p)
    t0 = time.perf_counter()
    state = cloth_run(solver, state, frames, SUBSTEPS, DT, p)
    elapsed = time.perf_counter() - t0
    no_tpu_kernel(label)
    N = units or model.particle_count
    rate = N * frames * SUBSTEPS / elapsed
    res = dict(particles=model.particle_count, setup_s=setup_s,
               substeps=frames * SUBSTEPS, particle_steps_per_s=rate,
               gates=None if gates is None else gates(model, state))
    if "xpbd:grid_overflow" in state.custom:
        res["grid_overflow_last_substep"] = int(
            state.custom["xpbd:grid_overflow"].sum())

    def one():
        return solver.step(state, None, None,
                           None if p is None else p.collide(state), DT)
    repeat_fields(one, [n for n in REPEAT_FIELDS_CLOTH
                        if getattr(state, n).numel()]
                  + [k for k in ("xpbd:grid_overflow", "xpbd:dahl_f")
                     if k in state.custom], label)
    res.update(path_metrics(
        lambda: cloth_run(solver, state, 1, SUBSTEPS, DT, p), one, N, rate))
    return res, model, state


def phase_xpbd_cloth(dev, style3d_rate=None):
    """The bench cloth (bench.py --mode cloth's 100 x 100 grid) under
    SolverXPBD(iterations=4, enable_particle_particle=False): 10 warm-up
    and 10 timed frames, phase 24's gates and card-vs-CPU substep
    (bench_cloth_phase), beside Style3D's rate in this call (phase 24's,
    or, run alone, Style3D's over the same frames); a 20 x 20 grid of the
    same cell four substeps on the card against the CPU (2e-4 / 5e-3);
    host syncs per substep."""
    import newton_tpu_torch as nt
    if style3d_rate is None:
        style3d_rate = bench_cloth_phase(
            dev, lambda m: nt.SolverStyle3D(m, iterations=CLOTH_ITERS),
            FRAMES, "cloth style3d")["vertex_steps_per_s"]

    def make(m):
        return nt.SolverXPBD(m, iterations=XPBD_CLOTH_ITERS,
                             enable_particle_particle=False)
    made = []

    def make_kept(m):
        made.append((m, make(m)))
        return made[-1][1]
    # XPBD's membrane is the triangles' edge springs at tri_ke 500: the
    # drape stretches past Style3D's 2.5 x gate (the JAX package's too),
    # so the drape is reported and the pinned row and finiteness gated
    res = bench_cloth_phase(dev, make_kept, FRAMES, "XPBD bench cloth",
                            drape=False)
    m, solver = made[0]
    s0 = m.state()
    res["host_syncs_per_substep"] = count_syncs(
        lambda: solver.step(s0, None, None, None, DT))[1]
    small = cloth_bench_scene(nt, XPBD_CPU_DIM)
    res["vs_cpu_20x20_4_substeps"] = xpbd_vs_cpu(
        dev, small, make, small.finalize("cpu").state(), SUBSTEPS, DT,
        "XPBD cloth 20 x 20")
    res["style3d_vertex_steps_per_s"] = style3d_rate
    return res


def layer_separation(model, state):
    """The least distance between a particle of the first layer and one of
    the second."""
    import torch
    q = state.particle_q
    n = q.shape[0] // 2
    best = float("inf")
    for i in range(0, n, 2048):
        best = min(best, float(torch.cdist(
            q[i:min(i + 2048, n)], q[n:],
            compute_mode="donot_use_mm_for_euclid_dist").min()))
    return best


def min_pair_distance(q, chunk=2048):
    """The least distance between two particles, in row chunks."""
    import torch
    best = float("inf")
    for i in range(0, q.shape[0], chunk):
        d = torch.cdist(q[i:i + chunk], q,
                        compute_mode="donot_use_mm_for_euclid_dist")
        rows = torch.arange(i, min(i + chunk, q.shape[0]), device=q.device)
        d[rows - i, rows] = float("inf")
        best = min(best, float(d.min()))
    return best


def phase_xpbd_particles(dev):
    """(a) XPBD self-collision: the two layers of tests/test_cloth_solvers
    .py:58 widened to 70 x 70 cells each (10,082 particles),
    SolverXPBD(iterations=4) with particle-particle contacts through the
    hash grid (cell 0.06, 4 candidates per cell), 10 frames: finite and
    the layers separated by more than 0.025 (test_xpbd_cloth_self_
    collision), the grid's dropped candidates counted; one substep card vs
    CPU. (b) The granular pile: 64 x 64 x 8 particles (32,768, MPM sand's
    count) of radius 0.05 on a ground plane, SolverXPBD(iterations=3),
    soft contacts each substep, 50 warm-up and 10 frames: finite, every
    particle above z = 0.03 and no two closer than 0.085 (test_xpbd_
    granular_no_interpenetration) with the grid's budget raised to 8
    candidates per hashed cell (``particle_max_per_cell``: the default 4
    drops 50,212 candidates of the start state, ROADMAP C.25; both counts
    reported), one substep card vs CPU. Each with no
    B1-B4 launch, a substep twice bit for bit, device ms and operations
    of a substep, busy share, host syncs per substep, peak memory."""
    import torch
    import newton_tpu_torch as nt
    out = {}

    def layer_gates(model, state):
        q = state.particle_q
        sep = layer_separation(model, state)
        g = dict(finite=bool(torch.isfinite(q).all()), separation=sep)
        if not (g["finite"] and sep > 0.025):
            raise AssertionError(f"XPBD layers: gates fail {g}")
        return g

    def make_layers(m):
        return nt.SolverXPBD(m, iterations=4)
    b = layers_scene(nt)
    res, model, state = xpbd_particle_phase(dev, b, make_layers, 0,
                                            LAYER_FRAMES, "XPBD layers",
                                            gates=layer_gates)
    res["vs_cpu"] = xpbd_vs_cpu(dev, b, make_layers, state, 1, DT,
                                "XPBD layers")
    out["self_collision"] = res

    def gran_gates(model, state):
        q = state.particle_q
        g = dict(finite=bool(torch.isfinite(q).all()),
                 z_min=float(q[:, 2].min()), pair_min=min_pair_distance(q))
        if not (g["finite"] and g["z_min"] > 0.03 and g["pair_min"] > 0.085):
            raise AssertionError(f"granular: gates fail {g}")
        return g

    def make_gran(m):
        return nt.SolverXPBD(m, iterations=GRAN_ITERS,
                             particle_max_per_cell=GRAN_MAX_PER_CELL)
    b = granular_scene(nt)
    res, model, state = xpbd_particle_phase(dev, b, make_gran, GRAN_WARMUP,
                                            FRAMES, "granular", pipe=True,
                                            gates=gran_gates)
    res["vs_cpu"] = xpbd_vs_cpu(dev, b, make_gran, state, 1, DT, "granular",
                                pipe=True)
    # the default budget of 4 candidates per hashed cell drops contacts at
    # this count (ROADMAP C.25): counted at the start state for both
    from newton_tpu_torch.geometry.hashgrid import HashGrid
    q0 = model.particle_q
    res["start_overflow_by_budget"] = {
        k: int(HashGrid(cell_size=0.1, max_per_cell=k).query(
            q0, 0.1, count_overflow=True)[2].sum()) for k in (4, 8)}
    out["granular"] = res
    return out


def rigid_gates(state, label):
    """Finite bodies and unit quaternions (1e-3)."""
    import torch
    q = state.body_q
    g = dict(finite=bool(torch.isfinite(q).all() and torch.isfinite(
        state.body_qd).all()),
        quat_norm_err=float((q[:, 3:7].norm(dim=-1) - 1).abs().max()))
    if not (g["finite"] and g["quat_norm_err"] < 1e-3):
        raise AssertionError(f"{label}: gates fail {g}")
    return g


def graphed_steps(step, state, n, fields):
    """Substeps of ``step`` (a State to the next) replayed from one CUDA
    graph of it: a copy of ``state`` becomes the graph's inputs, and after
    each replay its ``fields`` (State fields or custom keys) are copied
    back into them. Returns (the inputs, ``replay(k=n)``); the caller may
    edit the inputs between replays. Used for gate windows that the eager
    host cost of a substep (the XPBD substep is ~9,000 eager operations)
    would make the run's longest; the timed windows stay eager."""
    import torch
    static = state.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            step(static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step(static)

    def get(x, f):
        return x.custom[f] if f in x.custom else getattr(x, f)

    def replay(k=n):
        for _ in range(k):
            graph.replay()
            for f in fields:
                get(static, f).copy_(get(out, f))
    return static, replay


def phase_cables(dev):
    """(a) example_cable_pile.py x 1024 (five rods of six cable segments,
    SolverXPBD(iterations=6), every candidate pair in static mode, dt
    1/240): 1 warm-up and 4 timed frames, finite and unit quaternions;
    (b) tests/test_cable.py's cantilevers at bend_ke 0.5, 5, 500 (three
    per world) x 1024, 1500 substeps of 1/960 under
    SolverXPBD(iterations=8) (replayed from a CUDA graph of the substep):
    the stiffer sags less in every world, the stiffest tip above 0.85 and
    the softest below 0.7 (test_cable_bend_stiffness_controls_sag); (c)
    example_cable_dahl_hysteresis.py x 1024 (friction_model="dahl", sigma
    5e4, iterations 8, the handle forward 0.5 s and back 0.5 s, dt 1/480,
    8 substeps, 60 frames from a CUDA graph, then 2 timed eager frames):
    finite, unit quaternions, the tail moved more than 5 mm and less than
    the handle's 0.2 m, the bristle state finite; (d) the Dahl presliding
    hold of tests/test_dahl_friction.py:63 x 1024 (a box pushed with 15 N,
    below mu m g = 39 N, for 30 frames (the test's 60), from a CUDA
    graph): every box crept
    less than 0.1 m. Each with no B1-B4 launch; (a) and (c): one substep
    card vs CPU (64 worlds: body_q 2e-4, body_qd 5e-3), a substep twice
    bit for bit, device ms and operations of a substep, busy share, host
    syncs per substep, peak memory, env-steps/s."""
    import torch
    import newton_tpu_torch as nt
    out = {}
    # (a) the pile
    b = cable_pile_scene(nt, CABLE_W)

    def make_pile(m):
        return nt.SolverXPBD(m, iterations=CABLE_ITERS)
    auto = {"mode": "auto"}             # the example's pipeline: dynamic
    res, model, state = xpbd_particle_phase(
        dev, b, make_pile, CABLE_WARMUP, PILE_FRAMES, "cable pile", pipe=True,
        gates=lambda m, s: rigid_gates(s, "cable pile"), units=CABLE_W,
        pipe_kw=auto)
    res["env_steps_per_s"] = res.pop("particle_steps_per_s")
    nb = model.body_count // CABLE_W
    res["pile_z_max"] = float(state.body_q[:, 2].max())
    dyn = nt.CollisionPipeline(model, **auto)
    if dyn.mode != "dynamic":
        raise AssertionError("cable pile: the example's pipeline is not "
                             "in dynamic mode")
    res["slots_per_world"] = dict(
        static=model.structure.rigid_contact_max // CABLE_W,
        dynamic=dyn.rigid_contact_max / CABLE_W)
    res["broad_phase_dropped_last_substep"] = int(
        dyn.collide(state).broad_phase_dropped)
    # one static collide of the start state: both modes activate the
    # same shape pairs
    s0 = model.state()
    same = torch.equal(touching_pairs(dyn.collide(s0)), touching_pairs(
        nt.CollisionPipeline(model, mode="static").collide(s0)))
    if not same:
        raise AssertionError("cable pile: dynamic and static modes activate "
                             "different shape pairs at the start state")
    res["start_pairs_equal_static"] = same
    small = cable_pile_scene(nt, PARITY_W)
    res["vs_cpu"] = xpbd_vs_cpu(dev, small, make_pile, world_slice(
        state, PARITY_W, nb, 0, 0), 1, DT, "cable pile", pipe=True,
        pipe_kw=auto)
    out["pile"] = res
    # (b) sag ordering
    torch.cuda.synchronize()
    b, tips = sag_scene(nt, SAG_W)
    model = b.finalize(dev)
    solver = nt.SolverXPBD(model, iterations=8)
    state = nt.eval_fk(model, model.joint_q0, model.joint_qd0, model.state())
    reset_all_launches()
    t0 = time.perf_counter()
    state, run = graphed_steps(
        lambda s: solver.step(s, None, None, None, SAG_DT), state,
        SAG_STEPS, ("body_q", "body_qd", "joint_q", "joint_qd"))
    run()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    no_tpu_kernel("cable sag")
    rigid_gates(state, "cable sag")
    nb = model.body_count // SAG_W
    z = state.body_q.view(SAG_W, nb, 7)[:, tips, 2]             # (W, 3)
    g = dict(ordered=bool(((z[:, 0] < z[:, 1]) & (z[:, 1] < z[:, 2])
                           & (z[:, 2] <= 1.01)).all()),
             stiff_min=float(z[:, 2].min()), soft_max=float(z[:, 0].max()),
             tips_mean=[float(x) for x in z.mean(0)])
    if not (g["ordered"] and g["stiff_min"] > 0.85 and g["soft_max"] < 0.7):
        raise AssertionError(f"cable sag: gates fail {g}")
    out["sag"] = dict(worlds=SAG_W, substeps=SAG_STEPS, gates=g,
                      graphed_s=elapsed)
    # (c) Dahl hysteresis
    b, handle, tail = dahl_scene(nt, DAHL_W)
    model = b.finalize(dev)
    pipe = nt.CollisionPipeline(model)

    def make_dahl(m):
        return nt.SolverXPBD(m, iterations=8, friction_model="dahl",
                             dahl_sigma=5.0e4)
    solver = make_dahl(model)
    state = solver.init_state(model.state())
    nb = model.body_count // DAHL_W
    hidx = torch.arange(DAHL_W, device=dev) * nb + handle

    def dahl_step(s):
        return solver.step(s, None, None, pipe.collide(s), DAHL_DT)
    reset_all_launches()
    t0 = time.perf_counter()
    state, run = graphed_steps(dahl_step, state, DAHL_SUBSTEPS,
                               ("body_q", "body_qd", "joint_q", "joint_qd",
                                "xpbd:dahl_f"))
    tail_x = []
    for f in range(DAHL_FRAMES):
        hv = 0.4 if (f * DAHL_SUBSTEPS * DAHL_DT) % 1.0 < 0.5 else -0.4
        state.body_qd[hidx, 0] = hv          # between replays, as the
        run()                                # example sets it per substep
        tail_x.append(state.body_q.view(DAHL_W, nb, 7)[:, tail, 0].clone())
    torch.cuda.synchronize()
    graphed_s = time.perf_counter() - t0
    no_tpu_kernel("Dahl hysteresis")
    rigid_gates(state, "Dahl hysteresis")
    tx = torch.stack(tail_x, 1)
    span = tx.max(1).values - tx.min(1).values
    g = dict(tail_span_min=float(span.min()), tail_span_max=float(span.max()),
             bristle_finite=bool(torch.isfinite(
                 state.custom["xpbd:dahl_f"]).all()))
    if not (g["tail_span_min"] > 0.005 and g["tail_span_max"] < 0.2
            and g["bristle_finite"]):
        raise AssertionError(f"Dahl hysteresis: gates fail {g}")
    state = state.clone()
    t0 = time.perf_counter()
    s = state
    for _ in range(DAHL_TIMED * DAHL_SUBSTEPS):
        s = dahl_step(s)
    torch.cuda.synchronize()
    rate = DAHL_TIMED * DAHL_SUBSTEPS * DAHL_W / (time.perf_counter() - t0)
    repeat_fields(lambda: dahl_step(state),
                  ("body_q", "body_qd", "xpbd:dahl_f"), "Dahl hysteresis")
    small, _, _ = dahl_scene(nt, PARITY_W)
    s64 = world_slice(state, PARITY_W, nb, 0, 0)
    s64.custom = {"xpbd:dahl_f": state.custom["xpbd:dahl_f"][
        :PARITY_W * pipe.rigid_contact_max // DAHL_W].clone()}
    vs = xpbd_vs_cpu(dev, small, make_dahl, s64, 1, DAHL_DT,
                     "Dahl hysteresis", pipe=True)
    out["dahl"] = dict(worlds=DAHL_W, substeps=DAHL_FRAMES * DAHL_SUBSTEPS,
                       gates=g, graphed_s=graphed_s, env_steps_per_s=rate,
                       vs_cpu=vs, **path_metrics(
                           lambda: [dahl_step(state)
                                    for _ in range(SUBSTEPS)],
                           lambda: dahl_step(state), DAHL_W, rate))
    # (d) presliding hold
    model = dahl_box_scene(nt, DAHL_W).finalize(dev)
    pipe = nt.CollisionPipeline(model)
    solver = nt.SolverXPBD(model, iterations=4, friction_model="dahl",
                           dahl_sigma=1.0e5)
    state = solver.init_state(model.state())
    state.body_f[:, 0] = HOLD_PUSH
    state, run = graphed_steps(
        lambda s: solver.step(s, None, None, pipe.collide(s), DT), state,
        HOLD_FRAMES * SUBSTEPS, ("body_q", "body_qd", "joint_q", "joint_qd",
                                 "xpbd:dahl_f"))
    run()
    torch.cuda.synchronize()
    rigid_gates(state, "Dahl hold")
    creep = float(state.body_q[:, 0].max())
    if not creep < 0.1:
        raise AssertionError(f"Dahl hold: a box crept {creep:.3f} m")
    out["hold"] = dict(worlds=DAHL_W, substeps=HOLD_FRAMES * SUBSTEPS,
                       creep_max=creep)
    no_tpu_kernel("Dahl hold")
    return out


def free_body_kernel_entries(conv, mnt, tower, b1_src, b2_src):
    """The kernels line's entries of phases 37-39: B1 at d = 12 (the
    conveyor, the tower), the mounted scene's two groups (d = 6, 2); B2 at
    (32, 0, 12) with w_other (the belt a moving support), the tower's
    (32, 0, 12) and the mounted groups' shapes."""
    out = []
    b1s = [(conv["b1_instance"], "conveyor x 4096, step_with_contacts "
            "(phase 37)", 12, CONVEYOR_W, conv["launches"][0],
            conv["b1_max_abs_err"], conv["b1"]),
           (tower["b1_instance"], "third-law tower x 4096, contact_cap=0 "
            "(phase 39)", 12, TOWER_W, tower["launches"][0],
            tower["b1_max_abs_err"], tower["b1"])]
    for gi, t in mnt["times"].items():
        b1s.append((t["b1_instance"], f"mounted arm x 4096, group {gi} of 2 "
                    "(phase 38)", t["d"], MOUNT_W, mnt["launches"][0],
                    mnt["paths"][f"b1 group {gi}"][0], t["b1"]))
    for label, path, d, n, launches, err, t in b1s:
        out.append(dict(
            name=f"chol_inv_solve [{label}] d={d} W={n}", **b1_src,
            instance=label, path=path, launches=launches, max_abs_err=err,
            ms=t["ms"], plain_ms=t["plain_ms"],
            **bound_fields("chol_inv_solve", t["ms"], d=d, W=n),
            library_ms=t["library_ms"]))
    b2s = [("conveyor x 4096, the belt's entries a moving support "
            "(w_other 0, constant rows) (phase 37)", CONVEYOR_W,
            conv["launches"][1], conv["b2"], CONVEYOR_ITERS, True),
           ("third-law tower x 4096, contact_cap=0 (phase 39)", TOWER_W,
            tower["launches"][1], tower["b2"], TOWER_ITERS, False)]
    for gi, t in mnt["times"].items():
        if "b2" in t:
            b2s.append((f"mounted arm x 4096, group {gi} (phase 38)",
                        MOUNT_W, mnt["launches"][1], t["b2"], ITERS, False))
    for path, n, launches, v, it, w_other in b2s:
        c, nl, d = v["shape"]
        tag = ", w_other" if w_other else ""
        out.append(dict(
            name=f"pgs_solve_fused [{v['instance']}{tag}] {v['shape']} "
                 f"W={n}", **b2_src, instance=v["instance"], path=path,
            launches=launches, max_abs_err=v["lam_err"], ms=v["ms"],
            plain_ms=v["plain_ms"],
            **bound_fields("pgs_solve_fused", v["ms"], c=c, nl=nl, d=d, W=n,
                           iters=it, w_other=w_other)))
    return out


def rest_kernel_entries(nqp, imp, ten, mus, kam, b1_src, b2_src):
    """The kernels line's entries of phases 32-36: B1 at d = 14 (the Newton
    QP ant), 23 (implicitfast), 2 (finger, arm), 18 (heavy stack), 8
    (four-bar), 36 (stacks); B2 at (25, 0, 14) (penalty limits) and
    (32, 17, 23) implicitfast and non-symmetric (implicit)."""
    from newton_tpu_torch.solvers.generalized import linalg
    out = []
    for path, d, n, launches, err, t in (
            ("ant x 4096 under the Newton QP (phase 32)", 14,
             NQP_W, nqp["ant_newton"]["launches"][0],
             nqp["ant_newton"]["b1"][0], nqp["ant_newton"]["b1_times"]),
            ("ant x 4096, penalty limits, no body forces "
             "(phase 32)", 14, NQP_W, nqp["ant_penalty"]["launches"][0],
             nqp["ant_penalty"]["b1"][0], nqp["ant_penalty"]["b1_times"]),
            ("humanoid x 4096, implicitfast: M + dt (Kd + D) "
             "(phase 33)", 23, HUMANOID_W,
             imp["implicitfast"]["launches"][0],
             imp["implicitfast"]["b1"][0], imp["implicitfast"]["b1_times"]),
            ("tendon finger x 4096, euler (phase 34)", 2, FINGER_W,
             ten["euler"]["launches"][0], ten["euler"]["b1"][0],
             ten["euler"]["b1_times"]),
            ("tendon finger x 4096, implicitfast (phase 34)", 2,
             FINGER_W, ten["implicitfast"]["launches"][0],
             ten["implicitfast"]["b1"][0], ten["implicitfast"]["b1_times"]),
            ("muscle arm x 4096, euler (phase 35)", 2, ARM_W,
             mus["arm_euler"]["launches"][0], mus["arm_euler"]["b1"][0],
             mus["arm_euler"]["b1_times"]),
            ("muscle arm x 4096, implicitfast (phase 35)", 2,
             ARM_W, mus["arm_implicitfast"]["launches"][0],
             mus["arm_implicitfast"]["b1"][0],
             mus["arm_implicitfast"]["b1_times"]),
            ("heavy stack x 1024, SolverKamino (phase 36)", 18,
             STACK_W, kam["heavy_stack"]["launches"][0],
             kam["heavy_stack"]["b1"][0], kam["heavy_stack"]["b1_times"]),
            ("four-bar x 4096, SolverKamino (phase 36)", 8,
             FOURBAR_W, kam["fourbar"]["launches"][0],
             kam["fourbar"]["b1"][0], kam["fourbar"]["b1_times"]),
            ("build_stacks(3, 2) x 1024, SolverKamino islands "
             "(phase 36)", 36, ISLAND_W, ISLAND_STEPS,
             kam["islands"]["b1"][0], kam["islands"]["b1_times"])):
        label = linalg.kernel_instance(d)
        out.append(dict(
            name=f"chol_inv_solve [{label}] d={d} W={n}", **b1_src,
            instance=label, path=path, launches=launches, max_abs_err=err,
            ms=t["ms"], plain_ms=t["plain_ms"],
            **bound_fields("chol_inv_solve", t["ms"], d=d, W=n),
            library_ms=t["library_ms"]))
    for key, path, n, launches, v, it in (
            ("penalty", "ant x 4096, penalty limits: no limit rows "
             "(phase 32)", NQP_W, nqp["ant_penalty"]["launches"][1],
             nqp["ant_penalty"]["b2"], ITERS),
            ("implicitfast", "humanoid x 4096, implicitfast (phase 33)",
             HUMANOID_W, imp["implicitfast"]["launches"][1],
             imp["implicitfast"]["b2"], ITERS),
            ("implicit", "humanoid x 4096, implicit: the non-symmetric form "
             "(Minv J^T) on the LU inverse (phase 33)", HUMANOID_W,
             imp["implicit"]["launches"][1], imp["implicit"]["b2"], ITERS)):
        c, nl, d = v["shape"]
        form = "" if v["symmetric"] else ", non-symmetric"
        out.append(dict(
            name=f"pgs_solve_fused [{v['instance']}{form}] {v['shape']} "
                 f"W={n}", **b2_src, instance=v["instance"], path=path,
            launches=launches, max_abs_err=v["lam_err"], ms=v["ms"],
            plain_ms=v["plain_ms"],
            **bound_fields("pgs_solve_fused", v["ms"], c=c, nl=nl, d=d, W=n,
                           iters=it)))
    return out


# ---------------------------------------------------------------------------
# phases 45-48: the other primitive shapes, dynamic collision, SAP and
# persistent manifolds
# ---------------------------------------------------------------------------
SHAPES_W = 4096
SHAPES_FRAMES = 30                    # tests/test_examples.py's: 60
CONE_FRAMES = 30                      # tests/test_geometry.py:464: 90
PILE_W = 1024
PILE_FRAMES_46 = 8                    # the example test's frame count
PILE_PARITY_W = 8
PEG_W = 4096
PEG_DT = 1.0 / 480.0
PEG_SUBSTEPS = 8
PEG_FRAMES = 30                       # tests/test_examples.py's: 80
MASS_W = 1024
MASS_FRAMES = 30                      # the example's test runs 60
MANIFOLD_PARITY_W = 16


def basic_shapes_scene(lib, n):
    """example_basic_shapes.py: a sphere, box, capsule, cylinder, cone and
    ellipsoid on free joints dropped from 0.6 m, 0.8 m apart along x, onto
    a ground plane; n worlds. Returns (builder, the rest test of each
    body: (z_rest, tol) or (None, (lo, hi)), as the example's
    test_final)."""
    sub = lib.ModelBuilder(gravity=-9.81)
    expect = []
    for x, add, rest in (
            (-2.0, lambda b: sub.add_shape_sphere(b, radius=0.2),
             (0.2, 0.03)),
            (-1.2, lambda b: sub.add_shape_box(b, hx=0.15, hy=0.15,
                                               hz=0.15), (0.15, 0.03)),
            (-0.4, lambda b: sub.add_shape_capsule(b, radius=0.12,
                                                   half_height=0.15),
             (None, (0.1, 0.3))),
            (0.4, lambda b: sub.add_shape_cylinder(b, radius=0.15,
                                                   half_height=0.12),
             (None, (0.1, 0.3))),
            (1.2, lambda b: sub.add_shape_cone(b, radius=0.15,
                                               half_height=0.15),
             (None, (0.08, 0.35))),
            (2.0, lambda b: sub.add_shape_ellipsoid(b, rx=0.2, ry=0.14,
                                                    rz=0.1),
             (None, (0.08, 0.25)))):
        body = sub.add_body(xform=[x, 0, 0.6, 0, 0, 0, 1])
        add(body)
        sub.add_joint_free(body)
        expect.append(rest)
    sub.add_ground_plane()
    return replicated(lib, sub, n), expect


def cone_stack_scene(lib, n):
    """tests/test_geometry.py:441: a cone (r 0.3, h 0.25) base-down on a
    box (0.5, 0.5, 0.25) on free joints above a ground plane; n worlds."""
    sub = lib.ModelBuilder()
    base = sub.add_body(xform=[0, 0, 0.25, 0, 0, 0, 1])
    sub.add_shape_box(base, hx=0.5, hy=0.5, hz=0.25)
    sub.add_joint_free(base)
    cone = sub.add_body(xform=[0, 0, 0.75, 0, 0, 0, 1])
    sub.add_shape_cone(cone, radius=0.3, half_height=0.25)
    sub.add_joint_free(cone)
    sub.add_ground_plane()
    return replicated(lib, sub, n)


def box_pile_scene(lib, n):
    """example_box_pile.py: 96 boxes of half-size 0.12 on free joints, six
    layers of 4 x 4 at a 0.3 pitch (jitter 0.02, seed 7) from 0.3 m, 0.35
    m apart, above a ground plane; n worlds."""
    import numpy as np
    sub = lib.ModelBuilder()
    rng = np.random.default_rng(7)
    for layer in range(6):
        for i in range(4):
            for j in range(4):
                x = (i - 2) * 0.3 + rng.uniform(-0.02, 0.02)
                y = (j - 2) * 0.3 + rng.uniform(-0.02, 0.02)
                body = sub.add_body(xform=[x, y, 0.3 + layer * 0.35, 0, 0,
                                           0, 1])
                sub.add_shape_box(body, hx=0.12, hy=0.12, hz=0.12)
                sub.add_joint_free(body)
    sub.add_ground_plane()
    return replicated(lib, sub, n)


def peg_scene(lib, n):
    """example_peg_insertion.py: a square peg (half-width 0.05, half-height
    0.1) 1 mm off-centre and turned 0.005 rad over a four-wall socket of
    1 mm clearance a side, mu 0.2, on a ground plane; n worlds."""
    import numpy as np
    sub = lib.ModelBuilder(gravity=-9.81)
    cfg = sub.default_shape_cfg.copy()
    cfg.mu = 0.2
    w, t, depth = 0.051, 0.02, 0.12
    for dx, dy, hx, hy in ((w + t, 0.0, t, w + 2 * t),
                           (-(w + t), 0.0, t, w + 2 * t),
                           (0.0, w + t, w, t), (0.0, -(w + t), w, t)):
        sub.add_shape_box(-1, xform=[dx, dy, depth, 0, 0, 0, 1], hx=hx,
                          hy=hy, hz=depth, cfg=cfg)
    q = [0.0, 0.0, float(np.sin(0.0025)), float(np.cos(0.0025))]
    peg = sub.add_body(xform=[0.0008, -0.0006, 2 * depth + 0.09] + q,
                       key="peg")
    sub.add_shape_box(peg, hx=0.05, hy=0.05, hz=0.1, cfg=cfg)
    sub.add_joint_free(peg)
    sub.add_ground_plane()
    return replicated(lib, sub, n)


def mass_ratio_scene(lib, n):
    """example_kamino_mass_ratio.py: an 800 kg block (density 1e5) on a
    0.8 kg box (density 100), both of half-size 0.1, on a ground plane;
    n worlds."""
    sub = lib.ModelBuilder(gravity=-9.81)
    light = sub.default_shape_cfg.copy()
    light.density = 100.0
    heavy = sub.default_shape_cfg.copy()
    heavy.density = 100000.0
    lb = sub.add_body(xform=[0, 0, 0.1, 0, 0, 0, 1], key="light")
    sub.add_shape_box(lb, hx=0.1, hy=0.1, hz=0.1, cfg=light)
    sub.add_joint_free(lb)
    hb = sub.add_body(xform=[0, 0, 0.3 * 1.003, 0, 0, 0, 1], key="heavy")
    sub.add_shape_box(hb, hx=0.1, hy=0.1, hz=0.1, cfg=heavy)
    sub.add_joint_free(hb)
    sub.add_ground_plane()
    return replicated(lib, sub, n)


def touching_pairs(c):
    """The sorted keys a S + b (a < b, S a large stride) of the shape pairs
    with an active slot: every world's at once, on the host."""
    import torch
    m = c.rigid_contact_mask
    a = c.rigid_contact_shape0[m].long()
    b = c.rigid_contact_shape1[m].long()
    return torch.unique(torch.minimum(a, b) * (1 << 24)
                        + torch.maximum(a, b)).cpu()


def count_ops(fn):
    """(fn's result, aten operations it dispatched)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))
    with Count():
        out = fn()
    return out, Count.n


def collide_ops(pipe, state):
    """Operations of one collide, of its support batch alone, and of the
    same support pairs run one class at a time (the JAX package's
    layout)."""
    _, total = count_ops(lambda: pipe.collide(state))
    X = pipe._aabb.world_transforms(state.body_q)
    jobs = [(pc, pc.shape0, pc.shape1) for pc in pipe.classes
            if pc.support]
    _, merged = count_ops(lambda: pipe._narrow(X, jobs))
    per_class = sum(count_ops(lambda j=j: pipe._narrow(X, [j]))[1]
                    for j in jobs)
    return dict(collide=total, support_batch=merged,
                support_share=merged / total, support_classes=len(jobs),
                support_one_class_at_a_time=per_class)


def host_ms(fn, n):
    """Mean wall time of one call: n calls, a synchronize closing the
    window (after 2 warm-up calls)."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def graphed_gate_run(step, state, n, fields):
    """``n`` substeps of ``step`` replayed from one CUDA graph (the gate
    windows of phases 43-45), the time of the replays."""
    import torch
    static, run = graphed_steps(step, state, n, fields)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    return static, time.perf_counter() - t0


def xpbd_rigid_phase(dev, builder, make_solver, frames, label, n, gate,
                     parity_builder, dt=DT, pipe_kw=None, parity_units=None):
    """A rigid XPBD scene of n worlds: setup; ``frames`` frames, then the
    gate ``gate(model, pipe, state)``. In static mode the frames replay
    from one CUDA graph of the substep and RATE_FRAMES eager frames after
    them give env-steps/s (the graph's replays give another); in dynamic
    mode (the box pile: device-bound, so a graph saves it nothing) they
    run eagerly, the first a warm-up and the rest timed for env-steps/s,
    with broad_phase_dropped summed per frame on the device. No B1-B4
    launch; 4 substeps of ``parity_builder``'s worlds (the first of the
    state's; the same pair budget a world) on the card against the CPU,
    every world compared, a tie of the contact geometry decided by a
    float64 run (see ``xpbd_vs_cpu``); one substep twice bit for bit;
    device ms, operations and busy share of a substep, host syncs per
    substep, peak memory. Returns (results, model, pipeline, state)."""
    import torch
    import newton_tpu_torch as nt
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = builder.finalize(dev)
    solver = make_solver(model)
    pipe = nt.CollisionPipeline(model, **(pipe_kw or {}))
    state = model.state()
    torch.cuda.synchronize()
    res = dict(worlds=n, setup_s=time.perf_counter() - t0, mode=pipe.mode,
               slots_per_world=pipe.rigid_contact_max / n)

    def step(s):
        return solver.step(s, None, None, pipe.collide(s), dt)
    reset_all_launches()
    fields = ("body_q", "body_qd", "joint_q", "joint_qd")
    n_sub = frames * SUBSTEPS
    if pipe.mode == "static":
        t0 = time.perf_counter()
        state, gate_s = graphed_gate_run(step, state, n_sub, fields)
        res.update(graph_capture_s=time.perf_counter() - t0 - gate_s,
                   gate_window_s=gate_s,
                   graph_env_steps_per_s=n_sub * n / gate_s)
        state = state.clone()
        t0 = time.perf_counter()
        s = state
        for _ in range(RATE_FRAMES * SUBSTEPS):
            s = step(s)
        torch.cuda.synchronize()
        res.update(rate_frames=RATE_FRAMES, env_steps_per_s=RATE_FRAMES
                   * SUBSTEPS * n / (time.perf_counter() - t0))
    else:
        dropped = []
        for f in range(frames):
            if f == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            d = torch.zeros((), dtype=torch.int32, device=dev)
            for _ in range(SUBSTEPS):
                c = pipe.collide(state)
                d = d + c.broad_phase_dropped
                state = solver.step(state, None, None, c, dt)
            dropped.append(d)
        torch.cuda.synchronize()
        res.update(rate_frames=frames - 1, env_steps_per_s=(frames - 1)
                   * SUBSTEPS * n / (time.perf_counter() - t0),
                   broad_phase_dropped_per_frame=[int(d) for d in dropped])
    rigid_gates(state, label)
    res["gates"] = gate(model, pipe, state)
    no_tpu_kernel(label)
    pw = max(parity_builder.world_count, 1)
    kw = dict(pipe_kw or {})
    if "dynamic_pair_budget" in kw:
        kw["dynamic_pair_budget"] = kw["dynamic_pair_budget"] * pw // n
    res["vs_cpu"] = xpbd_vs_cpu(
        dev, parity_builder, make_solver,
        world_slice(state, pw, model.body_count // n, 0, 0), SUBSTEPS, dt,
        label, pipe=True, pipe_kw=kw, ties=True, units=parity_units,
        max_left_out=PILE_LEFT_OUT if parity_units else 0)
    repeat_fields(lambda: step(state), fields, label)
    res["repeat_bit_equal"] = True
    res.update(path_metrics(
        lambda: [step(state) for _ in range(SUBSTEPS)],
        lambda: step(state), n, res["env_steps_per_s"]))
    return res, model, pipe, state


def shape_rest_gates(expect, n):
    """example_basic_shapes.py's test_final in every world: each body's
    z at its rest height within its tolerance, or inside its range."""
    def gate(model, pipe, state):
        z = state.body_q[:, 2].view(n, -1)
        g = {}
        for k, (rest, tol) in enumerate(expect):
            zk = z[:, k]
            ok = ((zk - rest).abs() < tol) if rest is not None else (
                (zk > tol[0]) & (zk < tol[1]))
            g[f"body{k}"] = dict(z_min=float(zk.min()), z_max=float(zk.max()),
                                 worlds_ok=int(ok.sum()))
            if not bool(ok.all()):
                raise AssertionError(f"basic shapes: body {k} off its rest "
                                     f"in {int((~ok).sum())} worlds {g}")
        return g
    return gate


def phase_shapes(dev):
    """(a) example_basic_shapes.py x 4096 as the example runs it:
    SolverXPBD(iterations=4), dt 1/240, 4 substeps, static mode, the cone
    and the ellipsoid against the others through one batch of support-map
    MPR; 30 frames (the example's 60) from a CUDA graph, then the
    example's test_final rest
    heights in every world; (b) tests/test_geometry.py:441's cone on a box
    x 4096, 30 frames (the test's 90): cone z = 0.75 +- 0.06 and upright
    in every world.
    Each: RATE_FRAMES timed eager frames (env-steps/s), no B1-B4 launch,
    4 substeps of 64 worlds of the gated state card vs CPU, a substep
    twice bit for bit, host syncs per substep, device ms and operations
    per frame; operations of one collide and the support batch's share,
    and the same support pairs one class at a time."""
    import newton_tpu_torch as nt
    out = {}
    b, expect = basic_shapes_scene(nt, SHAPES_W)

    def make(m):
        return nt.SolverXPBD(m, iterations=4)
    res, model, pipe, state = xpbd_rigid_phase(
        dev, b, make, SHAPES_FRAMES, "basic shapes", SHAPES_W,
        shape_rest_gates(expect, SHAPES_W),
        basic_shapes_scene(nt, PARITY_W)[0])
    res["ops"] = collide_ops(pipe, state)
    out["basic_shapes"] = res

    def cone_gate(model, pipe, state):
        q = state.body_q.view(SHAPES_W, 2, 7)[:, 1]
        g = dict(z_min=float(q[:, 2].min()), z_max=float(q[:, 2].max()),
                 tilt_max=float(q[:, 3:5].abs().max()))
        if not ((q[:, 2] - 0.75).abs().max() < 0.06 and g["tilt_max"] < 0.1):
            raise AssertionError(f"cone on a box: gates fail {g}")
        return g
    res, model, pipe, state = xpbd_rigid_phase(
        dev, cone_stack_scene(nt, SHAPES_W), make, CONE_FRAMES,
        "cone on a box", SHAPES_W, cone_gate,
        cone_stack_scene(nt, PARITY_W))
    res["ops"] = collide_ops(pipe, state)
    out["cone_on_box"] = res
    return out


def pile_gate(model, pipe, state):
    """example_box_pile.py's test_final in every world: finite poses,
    every z > 0, max z < 3, and fewer dynamic slots than static ones."""
    z = state.body_q[:, 2]
    g = dict(z_min=float(z.min()), z_max=float(z.max()),
             dynamic_slots=pipe.rigid_contact_max,
             static_slots=model.structure.rigid_contact_max)
    if not (g["z_min"] > 0.0 and g["z_max"] < 3.0
            and g["dynamic_slots"] < g["static_slots"]):
        raise AssertionError(f"box pile: gates fail {g}")
    return g


def compressed_pile(state):
    """The pile's bodies moved down so that each layer sits 5 mm into the
    one below and the lowest 5 mm into the ground (every box-box and
    box-ground pair of a column touching)."""
    import torch
    s = state.clone()
    layer = torch.round((s.body_q[:, 2] - 0.3) / 0.35)
    s.body_q[:, 2] = 0.115 + 0.235 * torch.clamp(layer, min=0.0)
    return s


def phase_box_pile(dev):
    """example_box_pile.py x 1024: 96 boxes a world, SolverXPBD(iterations
    =4), dt 1/120, 4 substeps, mode="dynamic" with a budget of 8 x 96 x W
    pairs (the example's 8 per box): the example test's 8 eager frames
    (the first a warm-up, 7 timed for env-steps/s, broad_phase_dropped
    summed per frame), its gates after them; no B1-B4 launch; 4 substeps
    of 8 worlds card vs CPU; a substep twice bit for bit (the per-call
    fixed-order sums); host syncs per substep, device ms and operations
    of a substep, busy share, peak memory."""
    import newton_tpu_torch as nt
    budget = 8 * 96 * PILE_W

    def make(m):
        return nt.SolverXPBD(m, iterations=4)
    res, model, pipe, state = xpbd_rigid_phase(
        dev, box_pile_scene(nt, PILE_W), make, PILE_FRAMES_46, "box pile",
        PILE_W, pile_gate, box_pile_scene(nt, PILE_PARITY_W),
        dt=1.0 / 120.0,
        pipe_kw=dict(mode="dynamic", dynamic_pair_budget=budget))
    res.update(budget_pairs=budget,
               static_slots_per_world=model.structure.rigid_contact_max
               // PILE_W)
    return res, model, pipe, state


def phase_pile_sap(dev):
    """Phases 46 and 47: the dynamic box pile, then SAP on its model."""
    pile = phase_box_pile(dev)
    return pile[0], phase_sap(dev, pile)


def sap_reach(model, pipe, state, pairs):
    """Of the pair keys ``pairs`` (``touching_pairs``), those that a
    windowed sweep over each world's own shapes reaches: both members of
    the pipeline's swept class (the pile has one: box-box), in one world
    and at most ``pipe.sap_window`` apart in that world's order of lower
    AABB bounds along ``pipe.sap_axis`` (ties by index); or a pair with
    a shape outside it (the plane classes: culled by height, not swept).
    The worlds' orders come from one numpy lexsort on the host."""
    import numpy as np
    import torch
    from newton_tpu_torch.geometry.broad_phase import compute_shape_aabbs
    (swept,) = [pc.sap.u.cpu().numpy() for pc in pipe.classes
                if getattr(pc, "sap", None) is not None]
    lo = compute_shape_aabbs(model, state, pipe.rigid_contact_margin,
                             pipe._aabb)[0][swept, pipe.sap_axis]
    world = np.asarray(model.structure.shape_world, dtype=np.int64)
    order = np.lexsort((swept, lo.cpu().numpy(), world[swept]))
    pos = np.full(len(world), -1, np.int64)
    pos[swept[order]] = np.arange(len(swept))
    a, b = (pairs >> 24).numpy(), (pairs & ((1 << 24) - 1)).numpy()
    keep = (pos[a] < 0) | (pos[b] < 0) | (
        (world[a] == world[b]) & (np.abs(pos[a] - pos[b]) <= pipe.sap_window))
    return pairs[torch.as_tensor(keep)]


def phase_sap(dev, pile):
    """The box pile of phase 46 with broad_phase="sap" (window 16): at the
    start state, after phase 46's 8 frames, and with every layer
    compressed 5 mm into the next, its set of active shape pairs equals
    exactly those of top-k's that a window of 16 reaches in each world's
    own order (``sap_reach``: the check that the sort keeps every world's
    shapes apart exactly, ROADMAP C.26 not copied; a column's 24 boxes
    share an x range, so a window of 16 misses some touching pairs once
    the layers touch, as the JAX package's SAP does). Both broad phases'
    collide timed in this call (device time, CUDA events on a held stream;
    wall time); a SAP substep twice bit for bit; host syncs of a SAP
    collide."""
    import torch
    import newton_tpu_torch as nt
    model, topk, state = pile[1], pile[2], pile[3]
    sap = nt.CollisionPipeline(model, mode="dynamic", broad_phase="sap",
                               sap_window=16,
                               dynamic_pair_budget=topk.dynamic_pair_budget)
    res = dict(worlds=PILE_W, window=16)
    checks = {}
    for label, s in (("start", model.state()), ("after 8 frames", state),
                     ("compressed", compressed_pile(state))):
        c = sap.collide(s)
        a, b = touching_pairs(topk.collide(s)), touching_pairs(c)
        reach = sap_reach(model, sap, s, a)
        checks[label] = dict(topk_pairs=int(a.numel()),
                             topk_pairs_in_window=int(reach.numel()),
                             sap_pairs=int(b.numel()),
                             equal_to_topk=torch.equal(a, b),
                             sap_dropped=int(c.broad_phase_dropped))
        if not torch.equal(b, reach):
            raise AssertionError(
                f"SAP at {label}: {b.numel()} active pairs against the "
                f"{reach.numel()} of top-k's {a.numel()} that its window "
                "reaches")
    res["checks"] = checks
    s = compressed_pile(state)
    res["collide_ms"] = {k: dict(
        device=time_ms(lambda p=p: p.collide(s), n=10, queued=True),
        wall=host_ms(lambda p=p: p.collide(s), 10))
        for k, p in (("topk", topk), ("sap", sap))}
    _, res["host_syncs_per_collide"] = count_syncs(lambda: sap.collide(s))
    solver = nt.SolverXPBD(model, iterations=4)
    repeat_fields(lambda: solver.step(s, None, None, sap.collide(s),
                                      1.0 / 120.0),
                  ("body_q", "body_qd"), "SAP pile")
    res["repeat_bit_equal"] = True
    return res


def manifold_phase(dev, make_scene, make_solver, n, frames, substeps, dt,
                   label, gate, b2=True):
    """A scene of n worlds on persistent manifolds under a generalized
    solver: ``frames`` frames of ``substeps`` substeps of
    ``collide(s, prev=c)`` then ``step``; launches (one B1, and one B2
    where ``b2``, per substep); the gate; env-steps/s; a kernel vs plain
    substep (B1 and B2 against their plain versions on its operands);
    B2 and B1 timed on captured operands; 4 substeps of 16 worlds card vs
    CPU; a substep twice bit for bit; host syncs per substep; device ms,
    operations and busy share; peak memory."""
    import torch
    import newton_tpu_torch as nt
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = make_scene(nt, n).finalize(dev)
    pipe = nt.CollisionPipeline(model, persistent_manifolds=True)
    solver = make_solver(model)
    state, c = solver.init_state(model.state()), pipe.contacts()
    ctl = model.control()
    torch.cuda.synchronize()
    res = dict(worlds=n, setup_s=time.perf_counter() - t0,
               slots_per_world=pipe.rigid_contact_max / n)

    def run(s, c, k):
        for _ in range(k):
            c = pipe.collide(s, prev=c)
            s = solver.step(s, None, ctl, c, dt)
        return s, c
    reset_robot_launches()
    n_sub = frames * substeps
    t0 = time.perf_counter()
    state, c = run(state, c, n_sub)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = gen_launches()
    want = (n_sub, n_sub if b2 else 0, 0)
    if launches[:2] != want[:2] or launches[2]:
        raise AssertionError(f"{label}: launches {launches}, expected "
                             f"{want}")
    rigid_gates(state, label)
    res.update(substeps=n_sub, launches=launches, gates=gate(state),
               env_steps_per_s=n_sub * n / elapsed)
    contacts = pipe.collide(state, prev=c)
    errs, recs = group_paths(solver, state, ctl, contacts, dt, label)
    res["paths"] = errs
    res["b1"] = dict(d=recs[0]["chol"][0].shape[-1],
                     **b1_times(*recs[0]["chol"]))
    if b2:
        args, kw = recs[0]["pgs"]
        res["b2"] = b2_record(args, kw, label)
    sub = make_scene(nt, 1)
    m_c = make_scene(nt, MANIFOLD_PARITY_W).finalize("cpu")
    p_c = nt.CollisionPipeline(m_c, persistent_manifolds=True)
    x_c = make_solver(m_c)
    m_d = make_scene(nt, MANIFOLD_PARITY_W).finalize(dev)
    p_d = nt.CollisionPipeline(m_d, persistent_manifolds=True)
    x_d = make_solver(m_d)
    s_small = world_slice(state, MANIFOLD_PARITY_W, sub.body_count,
                          sub.joint_coord_count, sub.joint_dof_count)
    s_small.custom = {}
    out = {}
    for side, (m, p, x) in (("card", (m_d, p_d, x_d)),
                            ("cpu", (m_c, p_c, x_c))):
        s = x.init_state(s_small.to(m.body_q.device))
        k = p.contacts()
        for _ in range(4):
            k = p.collide(s, prev=k)
            s = x.step(s, None, None, k, dt)
        out[side] = s
    vs = {}
    for name, tol in (("body_q", 2e-4), ("body_qd", 5e-3),
                      ("joint_q", 2e-4), ("joint_qd", 5e-3)):
        ok, vs[name] = close(getattr(out["card"], name).cpu(),
                             getattr(out["cpu"], name), tol, tol)
        if not ok:
            raise AssertionError(f"{label}: {name} card vs CPU off "
                                 f"tolerance ({vs[name]:.3g})")
    res["vs_cpu"] = vs

    def one():
        k = pipe.collide(state, prev=c)
        return solver.step(state, None, ctl, k, dt)
    res["repeat_max_diff"] = repeat_bits(one, label)
    rate = res["env_steps_per_s"]
    res.update(path_metrics(lambda: run(state, c, substeps), one, n, rate))
    return res


def phase_manifolds(dev):
    """(a) example_peg_insertion.py x 4096: SolverMuJoCo(iterations=30,
    warm_start=False, contact_cap=0), dt 1/480, 8 substeps, 30 frames (the
    example's 80) of
    ``collide(s, prev=c)``: one B1 (d = 6) and one B2 (72, 0, 6) per
    substep; gate: the example's test_final (seated below the mouth,
    centred within 1 cm, upright > 0.98) in 99% of worlds; (b)
    example_kamino_mass_ratio.py x 1024: SolverKamino(iterations=32,
    contact_cap=0), dt 1/240, 30 frames (its test runs 60): one B1 (d =
    12) per substep, no
    B2 (its own PADMM); gate: light z = 0.1 +- 0.01 and heavy z = 0.3 +-
    0.012 in every world. Each: see ``manifold_phase``."""
    import newton_tpu_torch as nt
    out = {}

    def peg_gate(state):
        q = state.body_q.view(PEG_W, 1, 7)[:, 0]
        up = 1.0 - 2.0 * (q[:, 3] ** 2 + q[:, 4] ** 2)
        ok = ((q[:, 2] < 0.26) & (q[:, 0].abs() < 0.01)
              & (q[:, 1].abs() < 0.01) & (up > 0.98))
        g = dict(worlds_ok=int(ok.sum()), z_max=float(q[:, 2].max()),
                 upright_min=float(up.min()))
        if g["worlds_ok"] < 0.99 * PEG_W:
            raise AssertionError(f"peg insertion: gates fail {g}")
        return g
    out["peg"] = manifold_phase(
        dev, peg_scene, lambda m: nt.SolverMuJoCo(
            m, iterations=30, warm_start=False, contact_cap=0), PEG_W,
        PEG_FRAMES, PEG_SUBSTEPS, PEG_DT, "peg insertion", peg_gate)

    def mass_gate(state):
        z = state.body_q.view(MASS_W, 2, 7)[..., 2]
        g = dict(light_err_max=float((z[:, 0] - 0.1).abs().max()),
                 heavy_err_max=float((z[:, 1] - 0.3).abs().max()))
        if not (g["light_err_max"] < 0.01 and g["heavy_err_max"] < 0.012):
            raise AssertionError(f"mass ratio: gates fail {g}")
        return g
    out["mass_ratio"] = manifold_phase(
        dev, mass_ratio_scene, lambda m: nt.SolverKamino(
            m, iterations=32, contact_cap=0), MASS_W, MASS_FRAMES, SUBSTEPS,
        DT, "Kamino mass ratio", mass_gate, b2=False)
    return out


def shape_kernel_entries(man, b1_src, b2_src):
    """The kernels line's entries of phase 48: B1 at d = 6 (the peg) and
    d = 12 (the Kamino stack), B2 at (72, 0, 6) with 30 iterations."""
    out = []
    for key, path in (("peg", "peg insertion x 4096, persistent manifolds, "
                       "SolverMuJoCo (phase 48)"),
                      ("mass_ratio", "Kamino mass ratio x 1024, persistent "
                       "manifolds (phase 48)")):
        r = man[key]
        d, n = r["b1"]["d"], r["worlds"]
        from newton_tpu_torch.solvers.generalized import linalg
        inst = linalg.kernel_instance(d)
        out.append(dict(
            name=f"chol_inv_solve [{inst}] d={d} W={n}", **b1_src,
            instance=inst, path=path, launches=r["launches"][0],
            max_abs_err=r["paths"]["b1 group 0"][0], ms=r["b1"]["ms"],
            plain_ms=r["b1"]["plain_ms"],
            **bound_fields("chol_inv_solve", r["b1"]["ms"], d=d, W=n),
            library_ms=r["b1"]["library_ms"]))
    b2 = man["peg"]["b2"]
    c, nl, d = b2["shape"]
    out.append(dict(
        name=f"pgs_solve_fused [{b2['instance']}] {b2['shape']} W={PEG_W}",
        **b2_src, instance=b2["instance"],
        path="peg insertion x 4096: 4 walls x 16 box-box + 8 plane-box "
             "slots, contact_cap=0, 30 iterations (phase 48)",
        launches=man["peg"]["launches"][1], max_abs_err=b2["lam_err"],
        ms=b2["ms"], plain_ms=b2["plain_ms"],
        **bound_fields("pgs_solve_fused", b2["ms"], c=c, nl=nl, d=d,
                       W=PEG_W, iters=30)))
    return out


# ---------------------------------------------------------------------------
# phases 49-51: mesh, convex-hull, heightfield and hydroelastic contacts
# ---------------------------------------------------------------------------
TERRAIN_W = 4096                      # the terrain ant x 4096 (phase 49)
TERRAIN_RAISE = 0.6                   # example_terrain_ant.py's drop
TERRAIN_FRAMES = 40                   # timed frames after one warm-up:
# the feet meet the field after ~21 frames, so ~19 frames of contact
MESH_W = 1024                         # each scene of phase 50
MESH_FRAMES = 60                      # 1 s, the examples' test_final
MESH_STACK_FRAMES = 15                # the crates start at rest: 0.25 s
NUT_RES = 64                          # the torus's texture bake
PAD_KH = 5.0e5                        # example_compliant_pad.py
PAD_H = 0.1
PILE_HULLS = 512                      # example_pile_sap.py (phase 51)
PILE_SAP_FRAMES = 15                  # 0.5 s at dt 1/120, 4 substeps a
# frame: every layer has landed
PILE_SAP_DT = 1.0 / 120.0
PILE_LEFT_OUT = 4                     # hulls agreeing with neither CPU
# run (each with its witness, see xpbd_vs_cpu): one more than the most
# an H100 has shown (3)
TERRAIN_B2_DIV = 400                  # B2 rows with other guard halvings:
# at most W / 400 (10 of the terrain's 4096, which shows 6; 2 of the mesh
# stack's 1024, which shows 0)


def box_mesh(lib, h):
    """The examples' cube of half extent h as a 12-triangle mesh."""
    import numpy as np
    v = np.array([[x, y, z] for x in (-h, h) for y in (-h, h)
                  for z in (-h, h)], np.float64)
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5],
                  [0, 5, 1], [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4],
                  [1, 5, 7], [1, 7, 3]], np.int32)
    return lib.Mesh(v, f.reshape(-1))


def torus_mesh(lib, R=0.25, r=0.08, nu=24, nv=12):
    """example_nut_bolt_sdf.py's torus about +Z."""
    import numpy as np
    verts, faces = [], []
    for i in range(nu):
        a = 2 * np.pi * i / nu
        for j in range(nv):
            b = 2 * np.pi * j / nv
            verts.append([(R + r * np.cos(b)) * np.cos(a),
                          (R + r * np.cos(b)) * np.sin(a), r * np.sin(b)])
    for i in range(nu):
        for j in range(nv):
            a0, a1 = i * nv + j, i * nv + (j + 1) % nv
            b0, b1 = ((i + 1) % nu) * nv + j, ((i + 1) % nu) * nv + \
                (j + 1) % nv
            faces += [[a0, b0, b1], [a0, b1, a1]]
    return lib.Mesh(np.array(verts, np.float64),
                    np.array(faces, np.int32).reshape(-1))


def terrain_ant_scene(lib, n):
    """example_terrain_ant.py: gymnasium's ant over the example's 32 x 32
    fractal heightfield (12 m, amplitude 0.25, seed 3), its root raised
    0.6, in each of n worlds (the JAX package's replicate drops the
    actuators: its tests give the JAX builder its tables)."""
    import importlib
    import newton_tpu_torch as nt
    terrain = importlib.import_module(lib.__name__ + ".geometry.terrain")
    sub = lib.ModelBuilder()
    sub.add_mjcf(os.path.join(nt.ASSET_DIR, "ant.xml"))
    sub.add_shape_heightfield(-1, heightfield=terrain.generate_fractal_terrain(
        nx=32, ny=32, size_x=12.0, size_y=12.0, amplitude=0.25, seed=3))
    sub.joint_q[2] += TERRAIN_RAISE
    return replicated(lib, sub, n)


def mesh_stack_scene(lib, n):
    """example_mesh_stack.py: three 1 m crates (box meshes) on the ground,
    slightly offset, hydroelastic with SolverFeatherstone."""
    sub = lib.ModelBuilder()
    for i, (x, z) in enumerate(((0.0, 0.5), (0.1, 1.52), (-0.05, 2.54))):
        body = sub.add_body(xform=[x, 0, z, 0, 0, 0, 1], key=f"crate_{i}")
        sub.add_shape_mesh(body, mesh=box_mesh(lib, 0.5))
        sub.add_joint_free(body)
    sub.add_ground_plane()
    return replicated(lib, sub, n)


def compliant_pad_scene(lib, n):
    """example_compliant_pad.py: a 0.2 m cube mesh on a static 2 x 2 x 0.2
    pad, both of kh 5e5, hydroelastic under SolverXPBD."""
    sub = lib.ModelBuilder(gravity=-9.81)
    cfg = sub.default_shape_cfg.copy()
    cfg.kh = PAD_KH
    cfg.mu = 0.6
    sub.add_shape_box(-1, xform=[0, 0, -0.1, 0, 0, 0, 1], hx=1.0, hy=1.0,
                      hz=0.1, cfg=cfg, key="pad")
    body = sub.add_body(xform=[0, 0, PAD_H + 0.05, 0, 0, 0, 1])
    sub.add_shape_mesh(body, mesh=box_mesh(lib, PAD_H), cfg=cfg, key="cube")
    sub.add_joint_free(body)
    return replicated(lib, sub, n)


def nut_bolt_scene(lib, n, res=NUT_RES):
    """example_nut_bolt_sdf.py with the torus baked at ``res`` (64: the
    sparse texture): a static capsule shaft on a cylinder head, the torus
    nut dropped over it, a ground plane; SolverXPBD."""
    sub = lib.ModelBuilder()
    sub.add_shape_capsule(-1, xform=[0, 0, 0.55, 0, 0, 0, 1], radius=0.1,
                          half_height=0.45)
    sub.add_shape_cylinder(-1, xform=[0, 0, 0.05, 0, 0, 0, 1], radius=0.22,
                           half_height=0.05)
    nut = sub.add_body(xform=[0.03, 0.0, 1.4, 0, 0, 0, 1])
    cfg = sub.default_shape_cfg.copy()
    cfg.sdf_max_resolution = res
    sub.add_shape_mesh(nut, mesh=torus_mesh(lib), cfg=cfg)
    sub.add_joint_free(nut)
    sub.add_ground_plane()
    return replicated(lib, sub, n)


def convex_stack_scene(lib, n):
    """example_convex_stack.py: three 0.5 m box meshes made convex hulls
    (MPR, no bake) stacked on the ground; SolverXPBD."""
    sub = lib.ModelBuilder()
    mesh = box_mesh(lib, 0.25)
    for z in (0.25, 0.76, 1.27):
        body = sub.add_body(xform=[0, 0, z, 0, 0, 0, 1])
        sub.add_shape_mesh(body, mesh=mesh)
        sub.add_joint_free(body)
    sub.add_ground_plane()
    sub.approximate_meshes()
    return replicated(lib, sub, n)


def pile_sap_scene(lib, n_hulls=PILE_HULLS):
    """example_pile_sap.py: n_hulls convex octahedra (r 0.05) rained in
    layers of 64 over a pit, one world, a ground plane."""
    import numpy as np
    rng = np.random.default_rng(11)
    b = lib.ModelBuilder(gravity=-9.81)
    cfg = b.default_shape_cfg.copy()
    cfg.mu = 0.5
    r = 0.05
    v = np.array([[r, 0, 0], [-r, 0, 0], [0, r, 0], [0, -r, 0], [0, 0, r],
                  [0, 0, -r]], dtype=np.float64)
    f = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4], [2, 0, 5],
                  [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int32)
    mesh = lib.Mesh(v, f.reshape(-1), compute_inertia=True)
    for i in range(n_hulls):
        x, y = rng.uniform(-0.8, 0.8, 2)
        body = b.add_body(xform=[float(x), float(y), 0.1 + 0.13 * (i // 64),
                                 0, 0, 0, 1], key=f"hull_{i}")
        b.add_shape_convex_hull(body, mesh=mesh, cfg=cfg,
                                key=f"hull_shape_{i}")
        b.add_joint_free(body, key=f"hull_free_{i}")
    b.add_ground_plane()
    return b


def gen_mesh_phase(dev, make, solver_fn, n, warmup, frames, label, gate,
                   pipe_kw=None, sample_ctrl=False, field_slots=False,
                   witness=False):
    """A mesh-kind scene of n worlds under a generalized solver through
    replicate + step: setup (with the pooled SDF bytes); ``warmup`` frames
    then ``frames`` timed frames of SUBSTEPS substeps (a new uniform
    mjc:ctrl in [-1, 1] each frame with ``sample_ctrl``); B1 and B2 once a
    substep, counted; finite bodies and unit quaternions, and the gate; a
    substep through the kernels against the plain twins on the same state
    (B1, B2 on their operands; the states at 2e-4 / 5e-3); 64 worlds on
    the card against the CPU (with ``witness``, a world off tolerance
    held to a float64 CPU run); one substep twice bit for bit; env-steps/s
    of the kernel and plain paths in turns; device ms, busy share, host
    syncs per substep, peak memory; the mesh samples dropped; with
    ``field_slots``, how many worlds touched a heightfield in the last
    frame."""
    import numpy as np
    import torch
    import newton_tpu_torch as nt
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = make(nt, n).finalize(dev)
    finalize_s = time.perf_counter() - t0
    pipe = nt.CollisionPipeline(model, **(pipe_kw or {}))
    solver = solver_fn(model)
    state = solver.init_state(nt.eval_fk(model, model.joint_q0,
                                         model.joint_qd0, model.state()))
    ctl = model.control()
    sample = None
    if sample_ctrl:
        gen = torch.Generator(device=dev)
        gen.manual_seed(49)
        A = model.structure.mjc_actuation.n

        def sample(k):
            return [2 * torch.rand(A, generator=gen, device=dev) - 1
                    for _ in range(k)]
    torch.cuda.synchronize()
    res = dict(worlds=n, setup_s=time.perf_counter() - t0,
               finalize_s=finalize_s,
               groups=[(g.g.n, g.g.d) for g in solver.groups],
               slots_per_world=model.structure.rigid_contact_max / n,
               sdf_pool_bytes=model.sdf_grids.numel() * 4,
               sdf_texture_bytes=model.sdf_tex_blocks.numel()
               + model.sdf_tex_coarse.numel() * 4)
    state = run_steps(solver, state, ctl, warmup * SUBSTEPS, DT, True,
                      pipe=pipe, sample=sample)
    reset_robot_launches()
    n_sub = frames * SUBSTEPS
    t0 = time.perf_counter()
    state = run_steps(solver, state, ctl, n_sub - SUBSTEPS, DT, True,
                      pipe=pipe, sample=sample)
    seen = None
    if field_slots:
        # each world's heightfield slots (n, k), the same count a world
        st = model.structure
        on = st.shape_type[st.slot_shape1] == int(nt.GeoType.HFIELD)
        seen = (torch.as_tensor(np.nonzero(on)[0].reshape(n, -1),
                                device=dev),
                torch.zeros(n, dtype=torch.bool, device=dev))
    state = run_steps(solver, state, ctl, SUBSTEPS, DT, True, pipe=pipe,
                      sample=sample, touched=seen)
    elapsed = time.perf_counter() - t0
    if seen is not None:
        res["field_worlds"] = int(seen[1].sum())
    launches = gen_launches()
    if launches != (n_sub, n_sub, 0):
        raise AssertionError(f"{label}: launches {launches} in {n_sub} "
                             "substeps")
    rigid_gates(state, label)
    res.update(substeps=n_sub, launches=launches, gates=gate(state),
               main_env_steps_per_s=n_sub * n / elapsed)
    contacts = pipe.collide(state)
    res["mesh_samples_dropped"] = int(contacts.mesh_samples_dropped)
    res["active_slots_per_world"] = float(
        contacts.rigid_contact_mask.sum()) / n
    errs, recs = group_paths(solver, state, ctl, contacts, DT, label)
    Mi, rhs = recs[0]["chol"]
    args, kw = recs[0]["pgs"]
    # B2's guard halvings: N / TERRAIN_B2_DIV rows may differ (a halving
    # is a threshold decision on ||dlambda||^2 that the kernel's sum
    # order can tip); the rest must match
    res.update(paths=errs, b1=dict(d=Mi.shape[-1], **b1_times(Mi, rhs)),
               b2=b2_record(args, kw, label, mismatch_div=TERRAIN_B2_DIV))
    res["vs_cpu"], res["repeat_max_diff"] = flat_scene_checks(
        make, solver_fn, solver, state, ctl, DT, label, dev, pipe=pipe,
        pipe_kw=pipe_kw, witness=witness)
    rates, _, _ = turns(solver, state, state.clone(), ctl,
                        TURN_FRAMES * SUBSTEPS, n, DT, pipe=pipe,
                        sample=sample)
    rate = sum(rates[True]) / 2
    res.update(env_steps_per_s=rate,
               plain_env_steps_per_s=sum(rates[False]) / 2)
    res.update(path_metrics(
        lambda: run_steps(solver, state, ctl, SUBSTEPS, DT, True, pipe=pipe),
        lambda: solver.step(state, None, ctl, pipe.collide(state), DT), n,
        rate))
    if res["host_syncs_per_substep"]:
        raise AssertionError(f"{label}: {res['host_syncs_per_substep']} host "
                             f"syncs a substep: {SYNC_SITES}")
    return res


def phase_terrain(dev):
    """The slice's main path: example_terrain_ant.py x 4096 through
    replicate + SolverMuJoCo(iterations=8, integrator="euler").step, the
    static pipeline's flat (C,) Contacts (the floor's 25 slots and the
    heightfield's 52 a world: its two-sided class, the field's samples in
    each leg and the legs' samples in its 24^3 grid); one warm-up frame,
    then TERRAIN_FRAMES frames of 4 substeps at dt 1/240 with random
    ctrl; gates: finite, unit quaternions, every torso z in (-0.3, 1.5)
    (the example's test_final), B1 (d = 14) and B2 once a substep; the
    64 worlds against the CPU with a float64 witness; see
    ``gen_mesh_phase`` for the rest."""
    import newton_tpu_torch as nt

    def gate(state):
        z = state.joint_q.view(TERRAIN_W, -1)[:, 2]
        g = dict(torso_z_min=float(z.min()), torso_z_max=float(z.max()))
        if not (g["torso_z_min"] > -0.3 and g["torso_z_max"] < 1.5):
            raise AssertionError(f"terrain ant: gates fail {g}")
        return g
    res = gen_mesh_phase(
        dev, terrain_ant_scene, lambda m: nt.SolverMuJoCo(
            m, iterations=ITERS, integrator="euler"), TERRAIN_W, 1,
        TERRAIN_FRAMES, "terrain ant", gate, sample_ctrl=True,
        field_slots=True, witness=True)
    if res["field_worlds"] < TERRAIN_W // 4:
        raise AssertionError(f"terrain ant: only {res['field_worlds']} "
                             "worlds touch the heightfield")
    if res["groups"] != [(TERRAIN_W, 14)]:
        raise AssertionError(f"terrain ant: groups {res['groups']}")
    return res


def phase_mesh_scenes(dev):
    """Each x 1024 for 1 s (60 frames of 4 substeps, dt 1/240; the mesh
    stack, whose crates start at rest, 0.25 s), every world gated by its
    example's test_final, finite, unit quaternions, a
    substep twice bit for bit and no host sync:
    (a) example_mesh_stack.py, hydroelastic, SolverFeatherstone(
    contact_iterations=8): B1 (d = 18) and B2 on the mesh-mesh and
    mesh-plane rows once a substep (see ``gen_mesh_phase``);
    (b) example_compliant_pad.py, hydroelastic, SolverXPBD(iterations=8)
    with compliant rows: the settled depth within 30% of m g / (k_eff A);
    (c) example_nut_bolt_sdf.py with the torus at sdf_max_resolution=64
    (the sparse texture), SolverXPBD(iterations=4);
    (d) example_convex_stack.py, hulls through MPR, SolverXPBD(
    iterations=4). (b)-(d) launch no B1-B4 (see ``xpbd_rigid_phase``)."""
    import newton_tpu_torch as nt
    out = {}

    def stack_gate(state):
        z = state.body_q.view(MESH_W, 3, 7)[..., 2].sort(1).values
        err = (z - z.new_tensor([0.5, 1.5, 2.5])).abs().amax(0)
        g = dict(z_err_max=[float(e) for e in err])
        if not (g["z_err_max"][0] < 0.06 and g["z_err_max"][1] < 0.1
                and g["z_err_max"][2] < 0.15):
            raise AssertionError(f"mesh stack: gates fail {g}")
        return g
    t0 = time.perf_counter()
    out["mesh_stack"] = gen_mesh_phase(
        dev, mesh_stack_scene, lambda m: nt.SolverFeatherstone(
            m, contact_iterations=8), MESH_W, 0, MESH_STACK_FRAMES,
        "mesh stack", stack_gate, pipe_kw={"hydroelastic": True})
    out["mesh_stack"]["seconds"] = time.perf_counter() - t0

    def pad_gate(model, pipe, state):
        z = state.body_q[:, 2]
        mass = 1.0 / model.body_inv_mass
        delta = mass * 9.81 / ((PAD_KH / 2) * (2 * PAD_H) ** 2)
        err = ((PAD_H - z) / delta - 1).abs()
        g = dict(depth_rel_err_max=float(err.max()),
                 delta=float(delta[0]), depth_min=float((PAD_H - z).min()))
        if not g["depth_rel_err_max"] < 0.3:
            raise AssertionError(f"compliant pad: gates fail {g}")
        return g

    def nut_gate(model, pipe, state):
        q = state.body_q
        g = dict(radial_max=float(q[:, 0:2].norm(dim=1).max()),
                 z_min=float(q[:, 2].min()), z_max=float(q[:, 2].max()))
        if not (g["radial_max"] < 0.2 and g["z_min"] > 0.05
                and g["z_max"] < 1.0):
            raise AssertionError(f"nut and bolt: gates fail {g}")
        return g

    def convex_gate(model, pipe, state):
        z = state.body_q.view(MESH_W, 3, 7)[..., 2]
        err = float((z - z.new_tensor([0.25, 0.76, 1.27])).abs().max())
        if not err < 0.1:
            raise AssertionError(f"convex stack: gates fail {err}")
        return dict(z_err_max=err, sdf_grids=int(model.sdf_grids.shape[0]))
    for key, scene, iters, gate, kw in (
            ("compliant_pad", compliant_pad_scene, 8, pad_gate,
             {"hydroelastic": True}),
            ("nut_bolt", nut_bolt_scene, 4, nut_gate, None),
            ("convex_stack", convex_stack_scene, 4, convex_gate, None)):
        t0 = time.perf_counter()
        r, model, _, _ = xpbd_rigid_phase(
            dev, scene(nt, MESH_W), lambda m, k=iters: nt.SolverXPBD(
                m, iterations=k), MESH_FRAMES, key.replace("_", " "), MESH_W,
            gate, scene(nt, 2), pipe_kw=kw)
        if r["host_syncs_per_substep"]:
            raise AssertionError(f"{key}: host syncs {SYNC_SITES}")
        r["sdf_pool_bytes"] = model.sdf_grids.numel() * 4
        r["sdf_texture_blocks"] = int(model.sdf_tex_blocks.shape[0])
        r["seconds"] = time.perf_counter() - t0
        out[key] = r
    if out["convex_stack"]["gates"]["sdf_grids"] != 0:
        raise AssertionError("convex stack: hulls baked an SDF")
    if out["nut_bolt"]["sdf_texture_blocks"] == 0:
        raise AssertionError("nut and bolt: the torus has no texture")
    return out


def phase_pile_hulls(dev):
    """example_pile_sap.py as published: 512 convex octahedra, one world,
    SolverXPBD(iterations=4), CollisionPipeline(mode="dynamic",
    broad_phase="sap", dynamic_pair_budget=4096, sap_window=24): hull
    support pairs through MPR and plane-hull pairs, dt 1/120 for 0.5 s
    (every layer has landed);
    gates: broad_phase_dropped 0 in every substep, min z > -0.05, max
    z < 2 (its test_final); see ``xpbd_rigid_phase`` (the card against
    the CPU on the whole pile for 4 substeps, each hull held to the CPU
    in float32 or float64; at most 1% of them, whose contacts the MPR's
    ties of these axis-aligned octahedra decide by rounding, may agree
    with neither and are counted)."""
    import newton_tpu_torch as nt

    def gate(model, pipe, state):
        z = state.body_q[:, 2]
        g = dict(z_min=float(z.min()), z_max=float(z.max()))
        if not (g["z_min"] > -0.05 and g["z_max"] < 2.0):
            raise AssertionError(f"pile: gates fail {g}")
        return g
    kw = dict(mode="dynamic", broad_phase="sap", dynamic_pair_budget=4096,
              sap_window=24)
    res, _, pipe, _ = xpbd_rigid_phase(
        dev, pile_sap_scene(nt), lambda m: nt.SolverXPBD(m, iterations=4),
        PILE_SAP_FRAMES, "hull pile", 1, gate, pile_sap_scene(nt),
        dt=PILE_SAP_DT, pipe_kw=kw, parity_units=PILE_HULLS)
    if sum(res["broad_phase_dropped_per_frame"]):
        raise AssertionError(f"pile: SAP dropped pairs "
                             f"{res['broad_phase_dropped_per_frame']}")
    if res["host_syncs_per_substep"]:
        raise AssertionError(f"pile: host syncs {SYNC_SITES}")
    res["classes"] = [(pc.kind, pc.n, pc.cap) for pc in pipe.classes]
    return res


VBD_W = 4096                          # the VBD box stack x 4096 (phase 52)
VBD_ITERS = 8                         # example_vbd_rigid_rigid_contact.py
VBD_FRAMES = 50                       # its test_final's frame count
VBD_H = 0.12
VBD_PARITY_W = 16                     # worlds held to the CPU
PENDULUM_W = 4096
PENDULUM_FRAMES = 30                  # tests/test_solvers.py:319: 60
ROD_VBD_W = 1024
ROD_VBD_DT = 1.0 / 960.0              # tests/test_cable.py:121
ROD_VBD_STEPS = 600
COUPLED_W = 256                       # phase 53 (a), (b), (d)
SEESAW_DT = 1.0 / 480.0               # example_mujoco_xpbd_coupled.py
SEESAW_SUBSTEPS = 8
SEESAW_FRAMES = 60
CLOTH_BALL_FRAMES = 60                # tests/test_equality.py:89
PAIR_W = 4096                         # phase 53 (c)
PAIR_FRAMES = 120                     # tests/test_equality.py:260
TOWER_N, TOWER_BOX_H = 4, 0.08        # example_xpbd_vbd_coupled.py
COUPLED_PARITY_W = 4
COUPLED_SPACING = 2.0                 # m between the worlds of the
# particle scenes: particle-particle contacts do not look at worlds


def spaced(lib, sub, n, grid=None):
    """``sub`` alone for n = 1, else n copies of it, one world each,
    COUPLED_SPACING apart on a square grid laid out for ``grid`` worlds
    (default n; the first n places of a larger run's grid give the card-
    vs-CPU check the same worlds): the particle-particle contacts of the
    JAX package and the port do not look at worlds, so worlds with
    particles must not overlap."""
    import math
    if n == 1 and grid is None:
        return sub
    b = lib.ModelBuilder(gravity=sub.gravity)
    side = max(1, int(math.ceil(math.sqrt(grid or n))))
    for i in range(n):
        b.add_world(sub, xform=[(i % side) * COUPLED_SPACING,
                                (i // side) * COUPLED_SPACING, 0.0,
                                0.0, 0.0, 0.0, 1.0])
    return b


def vbd_stack_scene(lib, n):
    """example_vbd_rigid_rigid_contact.py: two boxes of half-size 0.12 (mu
    0.6) dropped from z = 0.15 and 0.6 (the upper 0.02 off in x) on a
    ground plane, in each of n worlds."""
    sub = lib.ModelBuilder(gravity=-9.81)
    cfg = sub.default_shape_cfg.copy()
    cfg.mu = 0.6
    for i, z in enumerate((0.15, 0.6)):
        body = sub.add_body(xform=[0.02 * i, 0.0, z, 0, 0, 0, 1],
                            key=f"box_{i}")
        sub.add_shape_box(body, hx=VBD_H, hy=VBD_H, hz=VBD_H, cfg=cfg)
        sub.add_joint_free(body)
    sub.add_ground_plane()
    return replicated(lib, sub, n)


def vbd_pendulum_scene(lib, n=1):
    """tests/test_solvers.py:319's pendulum: a 1 m bar on a ball joint at
    the origin, its centre 0.5 m out along x; n worlds."""
    sub = lib.ModelBuilder()
    link = sub.add_body(xform=[0.5, 0, 0, 0, 0, 0, 1])
    sub.add_shape_box(link, hx=0.5, hy=0.05, hz=0.05)
    sub.add_joint_ball(-1, link, xform_p=[0, 0, 0, 0, 0, 0, 1],
                       xform_c=[-0.5, 0, 0, 0, 0, 0, 1])
    return replicated(lib, sub, n)


def vbd_rod_scene(lib, n, bend_ke):
    """tests/test_cable.py:121's rod: six cable segments from (0, 0, 1)
    to (0.6, 0, 1), radius 0.01, stretch_ke 2e4, fixed root; n worlds."""
    sub = lib.ModelBuilder(gravity=-9.81)
    sub.add_rod([0, 0, 1.0], [0.6, 0, 1.0], segments=6, radius=0.01,
                joint="cable", bend_ke=bend_ke, stretch_ke=2.0e4,
                root_joint="fixed")
    return replicated(lib, sub, n)


def mixed_tower_scene(lib, n):
    """example_xpbd_vbd_coupled.py's tower: four boxes of half-size 0.08
    (mu 0.7) stacked 1% apart on a ground plane; n worlds."""
    sub = lib.ModelBuilder(gravity=-9.81)
    cfg = sub.default_shape_cfg.copy()
    cfg.mu = 0.7
    for i in range(TOWER_N):
        z = TOWER_BOX_H + 2 * TOWER_BOX_H * 1.01 * i
        body = sub.add_body(xform=[0, 0, z, 0, 0, 0, 1], key=f"box_{i}")
        sub.add_shape_box(body, hx=TOWER_BOX_H, hy=TOWER_BOX_H,
                          hz=TOWER_BOX_H, cfg=cfg)
        sub.add_joint_free(body)
    sub.add_ground_plane()
    return replicated(lib, sub, n)


def cloth_ball_scene(lib, n, grid=None):
    """example_coupled_cloth_ball.py: a free ball (r 0.2) at z = 0.5 under
    an 8 x 8 cloth (cell 0.08, mass 0.5, tri_ke 500, edge_ke 2) at z = 1
    over a ground plane; n worlds, COUPLED_SPACING apart."""
    sub = lib.ModelBuilder()
    body = sub.add_body(xform=[0.25, 0.25, 0.5, 0, 0, 0, 1], key="ball")
    sub.add_shape_sphere(body, radius=0.2)
    sub.add_joint_free(body)
    sub.add_ground_plane()
    sub.add_cloth_grid(pos=(0, 0, 1.0), dim_x=8, dim_y=8, cell_x=0.08,
                       cell_y=0.08, mass=0.5, tri_ke=500.0, edge_ke=2.0)
    return spaced(lib, sub, n, grid)


def seesaw_scene(lib, n, grid=None):
    """example_mujoco_xpbd_coupled.py: a plank (1 x 0.44 x 0.04) on a
    frictionless hinge about Y at z = 0.3, a 6 x 6 cloth (cell 0.05, mass
    0.8, radius 0.012, tri_ke 800, tri_kd 5, edge_ke 2) dropped over its +x
    end, a ground plane; n worlds, COUPLED_SPACING apart."""
    sub = lib.ModelBuilder(gravity=-9.81)
    plank = sub.add_body(xform=[0, 0, 0.3, 0, 0, 0, 1], key="plank")
    sub.add_shape_box(plank, hx=0.5, hy=0.22, hz=0.02)
    sub.add_joint_revolute(-1, plank, axis="Y",
                           xform_p=[0, 0, 0.3, 0, 0, 0, 1], key="hinge")
    sub.add_cloth_grid(pos=(0.22, -0.16, 0.45), dim_x=6, dim_y=6,
                       cell_x=0.05, cell_y=0.05, mass=0.8, radius=0.012,
                       tri_ke=800.0, tri_kd=5.0, edge_ke=2.0)
    sub.add_ground_plane()
    return spaced(lib, sub, n, grid)


def head_on_pair_scene(lib, n):
    """tests/test_equality.py:260's pair: two free spheres (r 0.2,
    restitution 0.9) 1 m apart at z = 0.5, no gravity; n worlds. The
    velocities (+-1 m/s along x) are set on the state."""
    sub = lib.ModelBuilder(gravity=0.0)
    cfg = sub.default_shape_cfg.copy()
    cfg.restitution = 0.9
    for x in (-0.5, 0.5):
        body = sub.add_body(xform=[x, 0, 0.5, 0, 0, 0, 1])
        sub.add_shape_sphere(body, radius=0.2, cfg=cfg)
        sub.add_joint_free(body)
    return replicated(lib, sub, n)


def particle_blob_scene(lib):
    """tests/test_equality.py:209's scene: a free box (0.8 x 0.8 x 0.2,
    density 500) under a blob of 40 particles (mass 0.05, seed 0), gravity
    -10, no ground."""
    import numpy as np
    b = lib.ModelBuilder(gravity=-10.0)
    box = b.add_body(xform=[0, 0, 0.0, 0, 0, 0, 1])
    b.add_shape_box(box, hx=0.4, hy=0.4, hz=0.1,
                    cfg=lib.ShapeConfig(density=500.0))
    b.add_joint_free(box)
    rng = np.random.RandomState(0)
    for p in rng.uniform(-0.2, 0.2, (40, 3)) * [1, 1, 0.5] + [0, 0, 0.5]:
        b.add_particle(p, (0, 0, 0), mass=0.05, radius=0.01)
    return b


def flat_slice(state, n, sub):
    """The first n worlds of a flat State of a model replicated from the
    one-world builder ``sub``: its bodies, coordinates, dofs and
    particles."""
    from dataclasses import replace
    s = world_slice(state, n, sub.body_count, sub.joint_coord_count,
                    sub.joint_dof_count)
    k = n * sub.particle_count
    return replace(s, particle_q=state.particle_q[:k].clone(),
                   particle_qd=state.particle_qd[:k].clone(),
                   particle_f=state.particle_f[:k].clone(), custom={})


def b1_solve_operands(step):
    """Run ``step`` (a SolverVBD step) with AVBD's ``linalg.chol_solve``
    calls recording their operands; returns the last call's (A, rhs)."""
    from types import SimpleNamespace
    from newton_tpu_torch.solvers import solver_vbd
    rec, lib = [], solver_vbd.linalg

    def recording(A, rhs):
        rec.append((A.clone(), rhs.clone()))
        return lib.chol_solve(A, rhs)
    solver_vbd.linalg = SimpleNamespace(chol_solve=recording)
    try:
        step()
    finally:
        solver_vbd.linalg = lib
    return rec[-1]


def b1_solve_record(step, label):
    """B1 without the inverse on the operands of ``step``'s last call:
    held against its plain version (``b1s_check``) and timed beside its
    plain version and torch.linalg.solve (``b1s_times``)."""
    A, rhs = b1_solve_operands(step)
    err, exact = b1s_check(A, rhs, label)
    return dict(W=A.shape[0], d=A.shape[-1], max_abs_err=err,
                bit_equal=exact, **b1s_times(A, rhs))


def eager_window(sub, state, substeps, n, label, per_substep):
    """``substeps`` eager substeps of ``sub`` (a State to the next) timed
    for env-steps/s, the kernels' launch counters set to 0 just before
    and read just after: ``per_substep`` (B1, B2, B1 without the inverse)
    launches a substep, each kernel listed launched at least once."""
    import torch
    torch.cuda.synchronize()
    reset_robot_launches()
    t0 = time.perf_counter()
    for _ in range(substeps):
        state = sub(state)
    torch.cuda.synchronize()
    rate = substeps * n / (time.perf_counter() - t0)
    launches = gen_launches()
    want = tuple(k * substeps for k in per_substep)
    if launches != want:
        raise AssertionError(f"{label}: launches {launches} in {substeps} "
                             f"substeps, want {want}")
    return state, dict(substeps=substeps, launches=launches,
                       env_steps_per_s=rate)


def phase_vbd_rigid(dev):
    """(a) The slice's main path: example_vbd_rigid_rigid_contact.py as
    published, x 4096 (``vbd_stack_scene``): CollisionPipeline(
    persistent_manifolds=True), SolverVBD(iterations=8), dt 1/240, 4
    substeps a frame, 50 frames eager, one B1 solve (``chol_solve``, d =
    6, W = 8192 bodies) a sweep, counted; the example's test_final in
    every world (box 0 at 0.12 within 0.05, box 1 at 0.36 within 0.09,
    |v| < 0.5); 16 worlds 4 substeps on the card against the CPU (a world
    off tolerance held to a float64 CPU run); one substep twice bit for
    bit; B1 against its plain version on the substep's operands, timed
    with torch.linalg.solve; device ops and aten calls a substep, busy
    share profiled and unprofiled, host syncs a substep (0 required).
    (b) tests/test_solvers.py:319's ball pendulum x 4096, SolverVBD(
    iterations=6), 30 frames (the test runs 60): the bar's centre within
    2e-3 of 0.5 from the pivot at every frame. (c)
    tests/test_cable.py:121's rod x 1024 at bend_ke 0.5 and 500 (600
    substeps at 1/960, replayed from a CUDA graph after an eager frame):
    the stiff tip above the floppy one and above 0.9, at most 1.01."""
    import torch
    import newton_tpu_torch as nt
    out = {}
    # (a) the box stack
    t0 = time.perf_counter()
    model = vbd_stack_scene(nt, VBD_W).finalize(dev)
    pipe = nt.CollisionPipeline(model, persistent_manifolds=True)
    solver = nt.SolverVBD(model, iterations=VBD_ITERS)
    torch.cuda.synchronize()
    res = dict(worlds=VBD_W, setup_s=time.perf_counter() - t0,
               slots_per_world=model.structure.rigid_contact_max / VBD_W)
    carry = [pipe.contacts()]

    def sub(s):
        carry[0] = pipe.collide(s, prev=carry[0])
        return solver.step(s, None, None, carry[0], DT)
    state, win = eager_window(sub, model.state(), VBD_FRAMES * SUBSTEPS,
                              VBD_W, "VBD box stack", (0, 0, VBD_ITERS))
    res.update(win)
    rigid_gates(state, "VBD box stack")
    z = state.body_q[:, 2].view(VBD_W, 2)
    g = dict(z0_err_max=float((z[:, 0] - VBD_H).abs().max()),
             z1_err_max=float((z[:, 1] - 3 * VBD_H).abs().max()),
             v_max=float(state.body_qd[:, 0:3].abs().max()))
    if not (g["z0_err_max"] < 0.05 and g["z1_err_max"] < 0.09
            and g["v_max"] < 0.5):
        raise AssertionError(f"VBD box stack: gates fail {g}")
    res["gates"] = g
    c = carry[0]
    res["active_slots_per_world"] = float(c.rigid_contact_mask.sum()) / VBD_W
    res["vs_cpu"] = xpbd_vs_cpu(
        dev, vbd_stack_scene(nt, VBD_PARITY_W),
        lambda m: nt.SolverVBD(m, iterations=VBD_ITERS),
        world_slice(state, VBD_PARITY_W, 2, 14, 12), SUBSTEPS, DT,
        "VBD box stack", pipe=True, pipe_kw={"persistent_manifolds": True},
        ties=True)
    repeat_fields(lambda: solver.step(state, None, None, c, DT),
                  ("body_q", "body_qd"), "VBD box stack")
    res["repeat_bit_equal"] = True
    res["b1"] = b1_solve_record(
        lambda: solver.step(state, None, None, c, DT), "VBD box stack")
    res["aten_ops_per_substep"] = count_ops(
        lambda: solver.step(state, None, None, pipe.collide(state, prev=c),
                            DT))[1]
    res.update(path_metrics(
        lambda: [solver.step(state, None, None, c, DT)
                 for _ in range(SUBSTEPS)],
        lambda: solver.step(state, None, None, pipe.collide(state, prev=c),
                            DT), VBD_W, res["env_steps_per_s"]))
    if res["host_syncs_per_substep"]:
        raise AssertionError(f"VBD box stack: host syncs {SYNC_SITES}")
    out["stack"] = res

    # (b) the ball pendulum
    t0 = time.perf_counter()
    model = vbd_pendulum_scene(nt, PENDULUM_W).finalize(dev)
    solver = nt.SolverVBD(model, iterations=6)
    state = nt.eval_fk(model, model.joint_q0, model.joint_qd0, model.state())
    worst = torch.zeros((), device=dev)
    zr = torch.tensor([1e9, -1e9], device=dev)
    substeps = 0
    reset_robot_launches()
    for _ in range(PENDULUM_FRAMES):
        for _ in range(SUBSTEPS):
            state = solver.step(state, None, None, None, DT)
            substeps += 1
        x = state.body_q[:, 0:3]
        worst = torch.maximum(worst, (x.norm(dim=1) - 0.5).abs().max())
        zr = torch.stack([torch.minimum(zr[0], x[:, 2].min()),
                          torch.maximum(zr[1], x[:, 2].max())])
    torch.cuda.synchronize()
    r = dict(worlds=PENDULUM_W, seconds=time.perf_counter() - t0,
             substeps=substeps, launches=gen_launches(),
             length_err_max=float(worst), z_range=[float(v) for v in zr])
    if r["launches"] != (0, 0, 6 * substeps):
        raise AssertionError(f"VBD pendulum: launches {r['launches']}")
    if not (r["length_err_max"] < 2e-3 and r["z_range"][0] > -0.501
            and r["z_range"][1] < 0.05):
        raise AssertionError(f"VBD pendulum: gates fail {r}")
    r["env_steps_per_s"] = substeps * PENDULUM_W / r["seconds"]
    r["b1"] = b1_solve_record(
        lambda: solver.step(state, None, None, None, DT), "VBD pendulum")
    out["pendulum"] = r

    # (c) the cable rod
    tips = []
    for ke in (0.5, 500.0):
        t0 = time.perf_counter()
        model = vbd_rod_scene(nt, ROD_VBD_W, ke).finalize(dev)
        solver = nt.SolverVBD(model, iterations=6)
        state = nt.eval_fk(model, model.joint_q0, model.joint_qd0,
                           model.state())

        def step(s, solver=solver):
            return solver.step(s, None, None, None, ROD_VBD_DT)
        state, win = eager_window(step, state, SUBSTEPS, ROD_VBD_W,
                                  f"VBD rod {ke}", (0, 0, 6))
        state, gate_s = graphed_gate_run(step, state,
                                         ROD_VBD_STEPS - SUBSTEPS,
                                         ("body_q", "body_qd"))
        nb = model.body_count // ROD_VBD_W
        tip = state.body_q.view(ROD_VBD_W, nb, 7)[:, -1, 2]
        tips.append(dict(bend_ke=ke, tip_z_min=float(tip.min()),
                         tip_z_max=float(tip.max()),
                         seconds=time.perf_counter() - t0,
                         graph_env_steps_per_s=(ROD_VBD_STEPS - SUBSTEPS)
                         * ROD_VBD_W / gate_s, **win))
        rigid_gates(state, f"VBD rod {ke}")
    if not (tips[0]["tip_z_max"] < tips[1]["tip_z_min"]
            and tips[1]["tip_z_max"] <= 1.01 and tips[1]["tip_z_min"] > 0.9):
        raise AssertionError(f"VBD rod: gates fail {tips}")
    out["rod"] = dict(runs=tips, b1=b1_solve_record(
        lambda: step(state), "VBD rod"))
    return out


def coupled_solver(lib, m, scene):
    """The SolverCoupled of phase 53's scene as its example or test builds
    it, and its dt (``lib``: the port, or the JAX package's solvers)."""
    import numpy as np
    S = getattr(lib, "solvers", lib)
    if scene == "seesaw":
        return S.SolverCoupled(
            m, rigid_solver=S.SolverMuJoCo(m, iterations=4),
            particle_solver=S.SolverXPBD(m, iterations=4),
            consensus_iters=2), SEESAW_DT
    if scene == "cloth_ball":
        return S.SolverCoupled(
            m, rigid_solver=S.SolverXPBD(m, iterations=2),
            particle_solver=S.SolverVBD(m, iterations=2)), DT
    if scene == "pair":
        return S.SolverCoupled(
            m, rigid_solver=S.SolverXPBD(m, iterations=4),
            second_rigid_solver=S.SolverMuJoCo(m, iterations=8),
            body_partition=np.arange(m.body_count) % 2 == 0,
            consensus_iters=1), DT
    return S.SolverCoupled(
        m, rigid_solver=S.SolverXPBD(m, iterations=8),
        second_rigid_solver=S.SolverVBD(m, iterations=8),
        body_partition=np.arange(m.body_count) % 2 == 0,
        consensus_iters=2), DT


SPACED = ("seesaw", "cloth_ball")    # the scenes with particles


def pair_velocities(state, n):
    """tests/test_equality.py:260's start: body 0 of each world at +1 m/s
    along x, body 1 at -1 m/s (body and joint velocities)."""
    from dataclasses import replace
    qd = state.body_qd.clone().view(n, 2, 6)
    qd[:, 0, 0], qd[:, 1, 0] = 1.0, -1.0
    jqd = state.joint_qd.clone().view(n, 12)
    jqd[:, 0], jqd[:, 6] = 1.0, -1.0
    return replace(state, body_qd=qd.view(-1, 6), joint_qd=jqd.view(-1))


def coupled_phase(dev, scene, make, n, frames, substeps, label, gate,
                  per_substep, eager_frames=2, graph=True,
                  parity_substeps=SUBSTEPS, parity_from_start=False):
    """A coupled scene of n worlds: setup; ``eager_frames`` eager frames
    timed, the launches of B1, B2 and B1 without the inverse counted a
    substep (``per_substep``); the rest of ``frames`` replayed from a
    CUDA graph of the substep (or eager); finite bodies and particles,
    unit quaternions and ``gate(state)``; COUPLED_PARITY_W worlds
    ``parity_substeps`` substeps on the card against the CPU from the
    window's end (or its start; a world off tolerance held to a float64
    CPU run); one
    substep twice bit for bit; device ops, busy share, host syncs a
    substep, peak memory. Returns (results, model, solver, state)."""
    import torch
    import newton_tpu_torch as nt
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = make(nt, n).finalize(dev)
    pipe = nt.CollisionPipeline(model)
    solver, dt = coupled_solver(nt, model, scene)
    state = solver.init_state(nt.eval_fk(model, model.joint_q0,
                                         model.joint_qd0, model.state()))
    if scene == "pair":
        state = pair_velocities(state, n)
    state0 = state.clone()
    ctl = model.control()
    torch.cuda.synchronize()
    res = dict(worlds=n, setup_s=time.perf_counter() - t0,
               particles=model.particle_count,
               soft_slots=model.structure.soft_contact_max,
               rigid_slots=model.structure.rigid_contact_max)

    def sub(s):
        return solver.step(s, None, ctl, pipe.collide(s), dt)
    state, win = eager_window(sub, state, eager_frames * substeps, n, label,
                              per_substep)
    res.update(win)
    rest = (frames - eager_frames) * substeps
    fields = ("body_q", "body_qd", "joint_q", "joint_qd", "particle_q",
              "particle_qd") + (("coupled:residuals",)
                                if "coupled:residuals" in state.custom
                                else ())
    t0 = time.perf_counter()
    if graph:
        state, gate_s = graphed_gate_run(sub, state, rest, fields)
        state = state.clone()
        res["graph_env_steps_per_s"] = rest * n / gate_s
    else:
        for _ in range(rest):
            state = sub(state)
        torch.cuda.synchronize()
    res["gate_window_s"] = time.perf_counter() - t0
    rigid_gates(state, label)
    if model.particle_count and not bool(torch.isfinite(
            state.particle_q).all()):
        raise AssertionError(f"{label}: particles not finite")
    res["gates"] = gate(model, state)
    if "coupled:residuals" in state.custom:
        res["residuals"] = [float(v) for v in
                            state.custom["coupled:residuals"]]
    sub1 = make(nt, 1)
    pb = (make(nt, COUPLED_PARITY_W, grid=n) if scene in SPACED
          else make(nt, COUPLED_PARITY_W))
    res["vs_cpu"] = xpbd_vs_cpu(
        dev, pb,
        lambda m: coupled_solver(nt, m, scene)[0],
        flat_slice(state0 if parity_from_start else state,
                   COUPLED_PARITY_W, sub1), parity_substeps, dt,
        label, pipe=True, ties=True)
    c = pipe.collide(state)
    repeat_fields(lambda: solver.step(state, None, ctl, c, dt),
                  fields[:6], label)
    res["repeat_bit_equal"] = True
    res.update(path_metrics(
        lambda: [sub(state) for _ in range(SUBSTEPS)], lambda: sub(state),
        n, res["env_steps_per_s"]))
    if res["host_syncs_per_substep"]:
        raise AssertionError(f"{label}: host syncs {SYNC_SITES}")
    return res, model, solver, state, ctl, pipe, dt


def phase_coupled(dev):
    """SolverCoupled, each scene replicated:
    (a) example_mujoco_xpbd_coupled.py's seesaw x 256: SolverMuJoCo(
    iterations=4) and SolverXPBD(iterations=4), consensus_iters=2,
    init_state's residuals, dt 1/480, 8 substeps a frame, 60 frames: per
    substep two B1 (d = 1) and two B2 launches (one per round), counted;
    the example's test_final in every world (the hinge tipped past 0.02,
    the cloth in (-0.01, 0.6)); B1 and B2 against their plain versions on
    the rigid step's operands, timed; 0 host syncs;
    (b) example_coupled_cloth_ball.py x 256: SolverXPBD(iterations=2)
    and SolverVBD(iterations=2) for the particles (its AVBD runs on the
    ball too: one B1 solve a sweep), 60 frames: the ball at z = 0.2 within
    0.05 in every world (tests/test_equality.py:89's gate);
    (c) tests/test_equality.py:260's head-on pair x 4096 split between
    SolverXPBD and SolverMuJoCo(iterations=8) by a body partition, 120
    frames: body 0 below -0.7 m/s, body 1 above 0.7, their sum within
    0.1 in every world; B1 and B2 against their plain versions;
    (d) example_xpbd_vbd_coupled.py's tower x 256 split between
    SolverXPBD(iterations=8) and SolverVBD(iterations=8): the JAX
    package's run fails its gate here (ROADMAP C.33), so 2 frames are
    gated on finiteness and held to the CPU over those 2 frames, and the
    boxes' z after 4 frames is reported."""
    import torch
    out = {}
    n_a = COUPLED_W

    def seesaw_gate(model, state):
        q = state.joint_q
        pz = state.particle_q[:, 2]
        g = dict(hinge_min=float(q.min()), cloth_z_min=float(pz.min()),
                 cloth_z_max=float(pz.max()))
        if not (g["hinge_min"] > 0.02 and g["cloth_z_min"] > -0.01
                and g["cloth_z_max"] < 0.6):
            raise AssertionError(f"seesaw: gates fail {g}")
        return g
    res, model, solver, state, ctl, pipe, dt = coupled_phase(
        dev, "seesaw", seesaw_scene, n_a, SEESAW_FRAMES, SEESAW_SUBSTEPS,
        "seesaw", seesaw_gate, (2, 2, 0))
    errs, recs = group_paths(solver.rigid_solver, state, ctl,
                             pipe.collide(state), dt, "seesaw")
    Mi, rhs = recs[0]["chol"]
    args, kw = recs[0]["pgs"]
    res.update(paths=errs, b1=dict(d=Mi.shape[-1], W=Mi.shape[0],
                                   **b1_times(Mi, rhs)),
               b2=b2_record(args, kw, "seesaw"))
    out["seesaw"] = res

    def ball_gate(model, state):
        z = state.body_q[:, 2]
        g = dict(ball_z_min=float(z.min()), ball_z_max=float(z.max()),
                 particle_speed_max=float(state.particle_qd.norm(
                     dim=1).max()))
        if not ((z - 0.2).abs().max() < 0.05):
            raise AssertionError(f"cloth on a ball: gates fail {g}")
        return g
    res, model, solver, state, ctl, pipe, dt = coupled_phase(
        dev, "cloth_ball", cloth_ball_scene, n_a, CLOTH_BALL_FRAMES,
        SUBSTEPS, "cloth on a ball", ball_gate, (0, 0, 2))
    c = pipe.collide(state)
    res["b1"] = b1_solve_record(
        lambda: solver.step(state, None, ctl, c, dt), "cloth on a ball")
    out["cloth_ball"] = res

    def pair_gate(model, state):
        v = state.body_qd[:, 0].view(-1, 2)
        g = dict(v0_max=float(v[:, 0].max()), v1_min=float(v[:, 1].min()),
                 momentum_err_max=float((v[:, 0] + v[:, 1]).abs().max()))
        if not (g["v0_max"] < -0.7 and g["v1_min"] > 0.7
                and g["momentum_err_max"] < 0.1):
            raise AssertionError(f"head-on pair: gates fail {g}")
        return g
    res, model, solver, state, ctl, pipe, dt = coupled_phase(
        dev, "pair", head_on_pair_scene, PAIR_W, PAIR_FRAMES, SUBSTEPS,
        "head-on pair", pair_gate, (1, 1, 0))
    # the pair's MuJoCo step on a state in contact: the window's end has
    # them apart, so the start is replayed to the collision (18 frames,
    # from a CUDA graph of the substep, as the gate window was)
    s = pair_velocities(solver.init_state(model.state()), PAIR_W)
    s, replay = graphed_steps(
        lambda x: solver.step(x, None, ctl, pipe.collide(x), dt), s,
        18 * SUBSTEPS, ("body_q", "body_qd", "joint_q", "joint_qd")
        + tuple(k for k in ("coupled:residuals",) if k in s.custom))
    replay()
    s = s.clone()
    c = pipe.collide(s)
    res["contact_worlds_at_collision"] = int(
        c.rigid_contact_mask.view(PAIR_W, -1).any(1).sum())
    errs, recs = group_paths(solver.second_rigid_solver, s, ctl, c, dt,
                             "head-on pair")
    Mi, rhs = recs[0]["chol"]
    args, kw = recs[0]["pgs"]
    res.update(paths=errs, b1=dict(d=Mi.shape[-1], W=Mi.shape[0],
                                   **b1_times(Mi, rhs)),
               b2=b2_record(args, kw, "head-on pair"))
    out["pair"] = res

    def tower_gate(model, state):
        return dict(finite=True)
    res, model, solver, state, ctl, pipe, dt = coupled_phase(
        dev, "tower", mixed_tower_scene, n_a, 2, SUBSTEPS, "mixed tower",
        tower_gate, (0, 0, VBD_ITERS * 2), eager_frames=2, graph=False,
        parity_substeps=2 * SUBSTEPS, parity_from_start=True)
    for _ in range(2 * SUBSTEPS):
        state = solver.step(state, None, ctl, pipe.collide(state), dt)
    z = state.body_q[:, 2].view(n_a, TOWER_N)
    res["box_z_frame_4"] = dict(
        median=[float(v) for v in z.median(0).values],
        min=[float(v) for v in z.min(0).values],
        max=[float(v) for v in z.max(0).values],
        target=[TOWER_BOX_H + 2 * TOWER_BOX_H * 1.01 * i
                for i in range(TOWER_N)],
        finite=bool(torch.isfinite(state.body_q).all()))
    c = pipe.collide(state)
    res["b1"] = b1_solve_record(
        lambda: solver.step(state, None, ctl, c, dt), "mixed tower")
    out["tower"] = res
    return out


def coupled_kernel_entries(vbd, cpl, b1_src, b2_src):
    """The kernels line's entries of phases 52-53: B1 without the inverse
    on AVBD's 6x6 systems (the main path and each other VBD path), and B1
    and B2 on the seesaw's and the pair's SolverMuJoCo."""
    from newton_tpu_torch.solvers.generalized import linalg
    out = []
    for r, launches, path in (
            (vbd["stack"]["b1"], vbd["stack"]["launches"][2],
             "VBD box stack x 4096, AVBD's per-body 6x6 systems (phase 52,"
             " the main path)"),
            (vbd["pendulum"]["b1"], vbd["pendulum"]["launches"][2],
             "VBD ball pendulum x 4096 (phase 52)"),
            (vbd["rod"]["b1"], vbd["rod"]["runs"][1]["launches"][2],
             "VBD cable rod x 1024, 6 bodies a world, one eager frame "
             "counted (phase 52)"),
            (cpl["cloth_ball"]["b1"], cpl["cloth_ball"]["launches"][2],
             "cloth on a ball x 256, SolverVBD's AVBD on the ball, two "
             "eager frames counted (phase 53)"),
            (cpl["tower"]["b1"], cpl["tower"]["launches"][2],
             "mixed tower x 256, SolverVBD's side of the partition, two "
             "frames counted (phase 53)")):
        d, n = r["d"], r["W"]
        inst = linalg.kernel_instance(d)
        out.append(dict(
            name=f"chol_solve [{inst}] d={d} W={n}", **dict(
                b1_src, library="torch.linalg.solve(A, rhs)"),
            instance=inst, path=path, launches=launches,
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"],
            **bound_fields("chol_solve", r["ms"], d=d, W=n),
            library_ms=r["library_ms"]))
    for key, path in (("seesaw", "seesaw x 256, SolverMuJoCo in "
                       "SolverCoupled's consensus: 2 a substep (phase 53)"),
                      ("pair", "head-on pair x 4096, SolverMuJoCo's side "
                       "of the body partition (phase 53)")):
        r = cpl[key]
        d, w = r["b1"]["d"], r["b1"]["W"]
        inst = linalg.kernel_instance(d)
        out.append(dict(
            name=f"chol_inv_solve [{inst}] d={d} W={w}", **b1_src,
            instance=inst, path=path, launches=r["launches"][0],
            max_abs_err=r["paths"]["b1 group 0"][0], ms=r["b1"]["ms"],
            plain_ms=r["b1"]["plain_ms"],
            **bound_fields("chol_inv_solve", r["b1"]["ms"], d=d, W=w),
            library_ms=r["b1"]["library_ms"]))
        b2 = r["b2"]
        c, nl, d = b2["shape"]
        out.append(dict(
            name=f"pgs_solve_fused [{b2['instance']}] {b2['shape']} W={w}",
            **b2_src, instance=b2["instance"], path=path,
            launches=r["launches"][1], max_abs_err=b2["lam_err"],
            ms=b2["ms"], plain_ms=b2["plain_ms"],
            **bound_fields("pgs_solve_fused", b2["ms"], c=c, nl=nl, d=d,
                           W=w, iters=b2.get("iters", ITERS))))
    return out


def mesh_kernel_entries(ter, mesh, b1_src, b2_src):
    """The kernels line's entries of phases 49-50: B1 and B2 at the
    terrain ant's shapes (the main path) and at the mesh stack's."""
    out = []
    for r, n, path in (
            (ter, TERRAIN_W, "terrain ant x 4096, replicate + step, the "
             "heightfield's two-sided slots (phase 49, the main path)"),
            (mesh["mesh_stack"], MESH_W, "hydroelastic mesh stack x 1024, "
             "SolverFeatherstone (phase 50)")):
        from newton_tpu_torch.solvers.generalized import linalg, pgs
        d = r["b1"]["d"]
        inst = linalg.kernel_instance(d)
        out.append(dict(
            name=f"chol_inv_solve [{inst}] d={d} W={n}", **b1_src,
            instance=inst, path=path, launches=r["launches"][0],
            max_abs_err=r["paths"]["b1 group 0"][0], ms=r["b1"]["ms"],
            plain_ms=r["b1"]["plain_ms"],
            **bound_fields("chol_inv_solve", r["b1"]["ms"], d=d, W=n),
            library_ms=r["b1"]["library_ms"]))
        b2 = r["b2"]
        c, nl, d = b2["shape"]
        out.append(dict(
            name=f"pgs_solve_fused [{b2['instance']}] {b2['shape']} W={n}",
            **b2_src, instance=b2["instance"], path=path,
            launches=r["launches"][1], max_abs_err=b2["lam_err"],
            ms=b2["ms"], plain_ms=b2["plain_ms"],
            **bound_fields("pgs_solve_fused", b2["ms"], c=c, nl=nl, d=d,
                           W=n, iters=b2.get("iters", ITERS))))
    return out


POLICY_W = 4096                       # the ONNX-policy ant x 4096 (54)
POLICY_KP, POLICY_KD = 40.0, 1.0          # the hinges' PD gains
POLICY_EFFORT = 150.0                     # ClampMaxEffort, ant.xml's gear
POLICY_DELAY = 2                          # Delay(2): one frame of lag
POLICY_HEALTHY = (0.2, 1.0)               # Ant-v5's healthy_z_range
POLICY_RESET_FRAME = 20                   # every 7th world reset here too
POLICY_RESET_EVERY = 7
POLICY_WARMUP = 5
POLICY_FRAMES = 60
POLICY_SIZES = (36, 64, 64, 8)
POLICY_TOL = {"joint_q": 2e-4, "joint_qd": 5e-3, "action": 1e-5}
FRANKA_XML = """
<mujoco model="panda">
  <compiler angle="radian" meshdir="{d}/meshes" inertiafromgeom="auto"/>
  <include file="{d}/assets.xml"/>
  <worldbody>
    <include file="{d}/chain.xml"/>
  </worldbody>
  <include file="{d}/actuator.xml"/>
</mujoco>
"""
FRANKA_COUNTS = dict(bodies=10, dofs=9, mesh_shapes=20, triangles=136040)
FRANKA_TARGETS = 4096
FRANKA_IK_TOL = 0.03                      # example_ik_franka.py's median


def policy_ant_scene(lib, n):
    """gymnasium's ant with a site keyed "imu" on its torso, in each of n
    worlds (the ground: each world's ant.xml floor)."""
    import newton_tpu_torch as nt
    sub = lib.ModelBuilder()
    sub.add_mjcf(os.path.join(nt.ASSET_DIR, "ant.xml"))
    sub.add_site(0, key="imu")
    return replicated(lib, sub, n)


def policy_layers(seed=0):
    """The policy MLP's [(W (in, out), b)]: W from N(0, 1) / sqrt(fan_in)
    (numpy default_rng(seed)), b = 0."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((a, b)).astype(np.float32) / np.sqrt(a),
             np.zeros(b, np.float32))
            for a, b in zip(POLICY_SIZES[:-1], POLICY_SIZES[1:])]


def policy_sensor_sets(st, n):
    """Each world's four lower-leg shapes and its floor shape (n, 4) and
    (n,), by key, in world order."""
    import numpy as np
    keys = np.asarray(st.shape_key)
    world = np.asarray(st.shape_world)
    legs = np.nonzero(np.char.endswith(keys, "ankle_geom"))[0]
    floors = np.nonzero(keys == "floor")[0]
    legs = legs.reshape(n, 4)
    if not ((world[legs] == np.arange(n)[:, None]).all()
            and (world[floors] == np.arange(n)).all()):
        raise AssertionError("policy ant: shapes not in world order")
    return legs, floors


class PolicyAnt:
    """Phase 54's loop on the port: ``frame(c, k)`` takes the carry ``c``
    (state, the state a frame earlier, the last Contacts with forces, the
    delay ring) through one policy call, 4 substeps and the reset, and
    returns (carry, observation, action, reset mask, the state before
    the reset). Nothing in a frame reads a value back to the host."""

    def __init__(self, nt, model, n, device, layers, reset_frame):
        import numpy as np
        import torch
        from newton_tpu_torch.actuators import (Actuator, ClampMaxEffort)
        from newton_tpu_torch.controllers import (ControllerPD, OnnxModule,
                                                  encode_mlp)
        from newton_tpu_torch.sensors import SensorContact, SensorIMU
        from newton_tpu_torch.utils import ArticulationView
        self.nt, self.model, self.n = nt, model, n
        self.reset_frame = reset_frame
        st = model.structure
        self.pipe = nt.CollisionPipeline(model)
        self.solver = nt.SolverMuJoCo(model, iterations=ITERS,
                                      integrator="euler")
        self.view = v = ArticulationView(model, "*")
        self.imu = SensorIMU(model, np.nonzero(
            np.asarray(st.shape_key) == "imu")[0])
        legs, floors = policy_sensor_sets(st, n)
        self.contact = SensorContact(model, legs.tolist(),
                                     [[f] for f in floors])
        self.policy = OnnxModule(encode_mlp(layers, "Tanh", "Tanh"),
                                 device=device)
        hinge_dofs, hinge_coords = v.dof_idx[:, 6:], v.coord_idx[:, 7:]
        self.actuator = Actuator(
            model, hinge_dofs.reshape(-1),
            ControllerPD(POLICY_KP, POLICY_KD,
                         coord_indices=hinge_coords.reshape(-1)),
            ClampMaxEffort(POLICY_EFFORT), delay_steps=POLICY_DELAY)
        lo, hi = (x[:, 6:] for x in v.get_dof_limits())
        self.mid, self.half = 0.5 * (lo + hi), 0.5 * (hi - lo)
        g = float(torch.linalg.vector_norm(model.gravity[0]))
        self.weight = (model.body_mass.view(n, -1).sum(1, keepdim=True)
                       * g)
        self.control = model.control()
        self.every = torch.arange(n, device=device) % POLICY_RESET_EVERY == 0

    def start(self):
        m = self.model
        s = self.nt.eval_fk(m, m.joint_q0, m.joint_qd0, m.state())
        return dict(state=s, prev=None, contacts=self.pipe.collide(s),
                    carry=self.actuator.init_carry())

    def observe(self, c):
        """The 36-wide observation of carry ``c``."""
        import torch
        v, s = self.view, c["state"]
        root = v.get_root_transforms(s)
        acc, gyro = self.imu.update(s, c["prev"], SUBSTEPS * DT)
        force, _ = self.contact.update(c["contacts"])
        return torch.cat([root[:, 2:3], root[:, 3:7],
                          v.get_dof_positions(s)[:, 7:],
                          v.get_root_velocities(s),
                          v.get_dof_velocities(s)[:, 6:], acc / 9.81, gyro,
                          force / self.weight], 1)

    def frame(self, c, k, kernels=True):
        s = c["state"]
        obs = self.observe(c)
        action = self.policy(obs)
        carry, ctl = self.actuator(c["carry"], s, self.control,
                                   (self.mid + self.half * action)
                                   .reshape(-1))
        prev = s
        contacts = None
        for _ in range(SUBSTEPS):
            s, contacts = self.solver.step_with_contacts(
                s, None, ctl, self.pipe.collide(s), DT, kernels=kernels)
        z = self.view.get_root_transforms(s)[:, 2]
        mask = (z < POLICY_HEALTHY[0]) | (z > POLICY_HEALTHY[1])
        if k == self.reset_frame:
            mask = mask | self.every
        before = s
        s = self.view.eval_fk(self.solver.reset(s, mask), mask)
        return (dict(state=s, prev=prev, contacts=contacts, carry=carry),
                obs, action, mask, before)


def policy_gates(loop, c, label):
    """Finite bodies and coordinates, unit quaternions."""
    import torch
    s = c["state"]
    for name in ("body_q", "body_qd", "joint_q", "joint_qd"):
        if not bool(torch.isfinite(getattr(s, name)).all()):
            raise AssertionError(f"{label}: non-finite {name}")
    qn = torch.linalg.vector_norm(s.body_q[:, 3:7], dim=-1)
    err = float((qn - 1).abs().max())
    if err > 1e-3:
        raise AssertionError(f"{label}: quaternion norms off by {err}")
    return dict(quat_norm_err=err)


def reset_gate(model, n, mask, before, after):
    """The reset worlds' joint_q/joint_qd are the model's initial ones bit
    for bit; the others are as before the reset, bit for bit."""
    import torch
    out = {}
    for name, init in (("joint_q", model.joint_q0),
                       ("joint_qd", model.joint_qd0)):
        a = getattr(after, name).view(n, -1)
        b = getattr(before, name).view(n, -1)
        i = init.view(n, -1)
        if not (torch.equal(a[mask], i[mask])
                and torch.equal(a[~mask], b[~mask])):
            raise AssertionError(f"policy ant: reset is not exact in {name}")
    out["worlds_reset_at_frame"] = int(mask.sum())
    return out


def phase_policy_ant(dev):
    """Phase 54 (see the module docstring)."""
    import torch
    import newton_tpu_torch as nt
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = policy_ant_scene(nt, POLICY_W).finalize(dev)
    loop = PolicyAnt(nt, model, POLICY_W, dev, policy_layers(),
                     POLICY_RESET_FRAME)
    c = loop.start()
    torch.cuda.synchronize()
    res = dict(worlds=POLICY_W, setup_s=time.perf_counter() - t0)
    for k in range(POLICY_WARMUP):
        c = loop.frame(c, k)[0]
    torch.cuda.synchronize()
    reset_robot_launches()
    n_reset = torch.zeros((), dtype=torch.long, device=dev)
    at_reset = None
    t0 = time.perf_counter()
    for k in range(POLICY_WARMUP, POLICY_WARMUP + POLICY_FRAMES):
        c, obs, action, mask, before = loop.frame(c, k)
        n_reset += mask.sum()
        if k == POLICY_RESET_FRAME:
            at_reset = (mask, before, c["state"])
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    n_sub = POLICY_FRAMES * SUBSTEPS
    launches = gen_launches()
    if launches != (n_sub, n_sub, 0):
        raise AssertionError(f"policy ant: launches {launches} in {n_sub} "
                             "substeps")
    res.update(frames=POLICY_FRAMES, substeps=n_sub, launches=launches,
               env_steps_per_s=n_sub * POLICY_W / elapsed,
               frame_ms=elapsed * 1e3 / POLICY_FRAMES,
               worlds_reset=int(n_reset),
               gates=policy_gates(loop, c, "policy ant"))
    res["gates"].update(reset_gate(model, POLICY_W, *at_reset))
    res["gates"]["torso_z_mean"] = float(
        loop.view.get_root_transforms(c["state"])[:, 2].mean())
    # a frame through the kernels against one through the plain versions
    k = POLICY_WARMUP + POLICY_FRAMES
    ck, _, ak, _, _ = loop.frame(c, k)
    cp, _, ap, _, _ = loop.frame(c, k, kernels=False)
    paths = {}
    for name, a, b in (("joint_q", ck["state"].joint_q, cp["state"].joint_q),
                       ("joint_qd", ck["state"].joint_qd,
                        cp["state"].joint_qd), ("action", ak, ap)):
        ok, e = close(a, b, POLICY_TOL[name], POLICY_TOL[name])
        if not ok:
            raise AssertionError(f"policy ant: {name} kernel vs plain frame "
                                 f"off tolerance ({e:.3g})")
        paths[name] = e
    # B1 and B2 against their twins on one substep's operands
    ctl = loop.actuator(c["carry"], c["state"], loop.control,
                        loop.mid.reshape(-1))[1]
    errs, recs = group_paths(loop.solver, c["state"], ctl,
                             loop.pipe.collide(c["state"]), DT, "policy ant")
    Mi, rhs = recs[0]["chol"]
    args, kw = recs[0]["pgs"]
    res.update(paths=paths, substep_paths=errs,
               b1=dict(d=Mi.shape[-1], **b1_times(Mi, rhs)),
               b2=b2_record(args, kw, "policy ant",
                            mismatch_div=TERRAIN_B2_DIV))
    # two runs of a frame, bit for bit; host syncs of a frame
    a, b = loop.frame(c, k), loop.frame(c, k)
    for name in REPEAT_FIELDS_RIGID:
        if not torch.equal(getattr(a[0]["state"], name),
                           getattr(b[0]["state"], name)):
            raise AssertionError(f"policy ant: two runs of a frame differ "
                                 f"in {name}")
    if not (torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])):
        raise AssertionError("policy ant: two runs of a frame differ in "
                             "the observation or the action")
    _, syncs = count_syncs(lambda: loop.frame(c, k))
    res.update(host_syncs_per_frame=syncs, sync_sites=list(SYNC_SITES))
    if syncs:
        raise AssertionError(f"policy ant: {syncs} host syncs a frame: "
                             f"{SYNC_SITES}")
    prof = profile_frame(lambda: loop.frame(c, k), SUBSTEPS)
    res.update(profile=prof, busy_share_unprofiled=busy_unprofiled(
        prof, POLICY_W, res["env_steps_per_s"]))
    if prof is not None:
        res["device_ms_per_frame"] = prof["device_busy_ms"]
        res["device_ops_per_frame"] = prof["device_ops"]
    obs = loop.observe(c)
    res["policy_ms"] = time_ms(lambda: loop.policy(obs), queued=True)
    res["sensor_ms"] = time_ms(lambda: loop.observe(c), queued=True)
    res["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    return res


def robotics_assets():
    """gymnasium-robotics' asset directory: $GYMNASIUM_ROBOTICS_ASSETS, else
    the installed package's (found without importing it), else None."""
    import importlib.util
    d = os.environ.get("GYMNASIUM_ROBOTICS_ASSETS")
    if d:
        return d
    spec = importlib.util.find_spec("gymnasium_robotics")
    if spec is None or not spec.submodule_search_locations:
        return None
    d = os.path.join(list(spec.submodule_search_locations)[0], "envs",
                     "assets")
    return d if os.path.isdir(d) else None


def franka_ik_targets(n, share=1.0):
    """example_ik_franka.py's circle (radius 0.1 about (0.45, 0, 0.55),
    y stretched to 0.15) at n angles over one turn, each times ``share``
    (share 0: every problem at the example's first target) (P, 3)."""
    import numpy as np
    ang = np.linspace(0.0, 2 * np.pi, n, endpoint=False) * share
    return np.stack([0.45 + 0.1 * np.cos(ang), 0.15 * np.sin(ang),
                     np.full(n, 0.55)], -1).astype(np.float32)


def franka_reach_error(model, ee, q, targets):
    """|link7's point (0, 0, 0.1) - target| (P,) at coordinates (P, Q)."""
    import torch
    from newton_tpu_torch.math import transform_point
    from newton_tpu_torch.sim.articulation import fk_bodies
    P = q.shape[0]
    bq, _ = fk_bodies(model, q, torch.zeros_like(q),
                      model.body_q.expand(P, -1, -1),
                      model.body_qd.expand(P, -1, -1))
    tip = transform_point(bq[:, ee], q.new_tensor([0.0, 0.0, 0.1]))
    return torch.linalg.vector_norm(tip - targets, dim=-1)


def phase_franka(dev, n_targets=FRANKA_TARGETS):
    """Phase 55 (see the module docstring); None where the assets are
    absent."""
    import numpy as np
    import torch
    import newton_tpu_torch as nt
    from newton_tpu_torch.ik import IKObjectivePosition, IKSolver
    assets = robotics_assets()
    if assets is None:
        return None
    t0 = time.perf_counter()
    b = nt.ModelBuilder(gravity=0.0)
    b.add_mjcf(FRANKA_XML.format(d=os.path.join(
        assets, "kitchen_franka", "franka_assets")))
    t1 = time.perf_counter()
    model = b.finalize(dev)
    res = dict(import_s=t1 - t0, finalize_s=time.perf_counter() - t1)
    st = model.structure
    mesh = np.nonzero(np.asarray(st.shape_type) == int(nt.GeoType.MESH))[0]
    counts = dict(bodies=st.body_count, dofs=model.joint_dof_count,
                  mesh_shapes=len(mesh),
                  triangles=sum(len(b.shape_source[i].indices) // 3
                                for i in mesh))
    if counts != FRANKA_COUNTS:
        raise AssertionError(f"Franka: counts {counts}, want "
                             f"{FRANKA_COUNTS}")
    ee = list(st.body_key).index("panda0_link7")
    ik = IKSolver(model, [IKObjectivePosition(link=ee,
                                              offset=(0.0, 0.0, 0.1))],
                  joint_limit_weight=0.1, iterations=12, n_seeds=2)
    # the example's tracking, batched: its first solve (from joint_q0 to
    # its first target) for every problem, then each problem's own point
    # of the circle from that pose, as the example follows the circle
    q = model.joint_q0.expand(n_targets, -1)
    ik.solve(q[:8], [torch.as_tensor(franka_ik_targets(8), device=dev)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for share in (0.0, 1.0):
        targets = torch.as_tensor(franka_ik_targets(n_targets, share),
                                  device=dev)
        q = ik.solve(q, [targets])
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    err = franka_reach_error(model, ee, q, targets)
    res.update(counts=counts, targets=n_targets, seeds=2, iterations=12,
               solves_per_s=2 * n_targets / solve_s,
               reach_err_median=float(err.median()),
               reach_err_max=float(err.max()))
    if not res["reach_err_median"] < FRANKA_IK_TOL:
        raise AssertionError(f"Franka IK: median reach error "
                             f"{res['reach_err_median']}")
    for name, path, want in (
            ("kitchen", "kitchen_franka/kitchen_assets/kitchen_env_model.xml",
             (43, 29, 150)),
            ("adroit_pen", "adroit_hand/adroit_pen.xml", (29, 30, 60))):
        t0 = time.perf_counter()
        b = nt.ModelBuilder()
        import warnings
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")      # the pen's tendon ranges
            b.add_mjcf(os.path.join(assets, path))
        m = b.finalize(dev)
        got = (m.structure.body_count, m.joint_dof_count,
               m.structure.shape_count)
        if got[:2] != want[:2] or not got[2] > want[2]:
            raise AssertionError(f"{name}: counts {got}, want {want}")
        res[name] = dict(bodies=got[0], dofs=got[1], shapes=got[2],
                         finalize_s=time.perf_counter() - t0)
    return res


CAM_W = 1024                          # the ant x 1024 filmed (phase 56)
CAM_RES = 64                          # one 64 x 64 camera per world
CAM_FOV = 0.7853981633974483          # MuJoCo's default fovy, 45 degrees
CAM_SPACING = (4.0, 4.0, 0.0)         # replicate's square grid, 32 x 32
CAM_OFFSET = (0.0, -3.0, 0.3)         # ant.xml:22, the "track" camera
CAM_QUAT = (0.7071067811865476, 0.0, 0.0, 0.7071067811865476)
CAM_FRAMES = 10
CAM_TORSO_R = 0.25                    # ant.xml's torso_geom
CAM_SEEN_SHARE = 0.99
CAM_DEPTH_TOL = 1e-4
CAM_PARITY_W = 16                     # K1 against its twin: R = 65,536
CAM_PLAIN_RAYS = 4096                 # the twin timed at the main shape
CAM_T_TOL = 1e-5                      # t: 1e-5 max(1, t)
CAM_N_TOL = 1e-4                      # normals
K2_RAYS = 65536                       # K2 against its twin
K2_BRUTE_RAYS = 4096                  # both against every triangle
# raycast_kernel_info(1-2): K2 without and with its counters
K2_INSTANCES = ("K2 raycast_mesh", "K2 raycast_mesh counting")
# K2's and K3's first designs (one thread per pair with a stack; one warp
# per env with T in global scratch) in run J3 of PERF.md, NVIDIA H100 80GB
# HBM3 at 700.00 W: printed, labelled as J3's, beside this run's times in
# phase 57 (a)'s and 58 (a)'s lines, and nowhere in the kernels line
FIRST_DESIGN_MS = {"K2": 0.8668, "K2 plain rays": 0.1708,
                   "K3 chol_inv_solve d=14": 0.0395,
                   "K3 chol_inv_solve d=23": 0.1457,
                   "K3 chol_solve d=6": 0.00845}
SPLAT_N = 256
TERRAIN_MESH = dict(nx=128, ny=128, size_x=128.0, size_y=128.0)


def camera_ant_scene(lib, n):
    """Gymnasium's ant in each of n worlds on replicate's square grid
    (the offset of world i is 4 (i mod 32), 4 (i div 32) for n = 1024;
    both packages apply it twice to a free root, so the ants stand 8 m
    apart: ROADMAP C.45); the ground is each world's ant.xml floor, n
    coincident z = 0 planes."""
    import newton_tpu_torch as nt
    sub = lib.ModelBuilder()
    sub.add_mjcf(os.path.join(nt.ASSET_DIR, "ant.xml"))
    b = lib.ModelBuilder(gravity=sub.gravity)
    b.replicate(sub, n, spacing=CAM_SPACING)
    return b


def camera_extras_scene(lib, n):
    """Phase 57's scene: camera_ant_scene with three global visual-only
    shapes (collision off): the fractal terrain (128 x 128 samples over
    128 m, amplitude 0.5, seed 57) as a MESH of 32,258 triangles under the
    grid (no bake), a 12 m fractal heightfield (amplitude 0.4, seed 58;
    sphere-traced through its bake) in the grid's middle, and a cloud of
    SPLAT_N Gaussians over it (numpy default_rng(57))."""
    import importlib
    import math
    import numpy as np
    terrain = importlib.import_module(lib.__name__ + ".geometry.terrain")
    b = camera_ant_scene(lib, n)
    cfg = b.default_shape_cfg.copy()
    cfg.has_shape_collision = False
    mid = (math.ceil(math.sqrt(n)) - 1) * CAM_SPACING[0]   # C.45: twice
    field = terrain.generate_fractal_terrain(**TERRAIN_MESH, seed=57)
    b.add_shape_mesh(-1, xform=[mid, mid, 0, 0, 0, 0, 1],
                     mesh=terrain.heightfield_to_mesh(field), cfg=cfg,
                     key="terrain_mesh")
    b.add_shape_heightfield(
        -1, xform=[mid, mid + 2.0, 0, 0, 0, 0, 1], cfg=cfg,
        key="heightfield", heightfield=terrain.generate_fractal_terrain(
            nx=32, ny=32, size_x=12.0, size_y=12.0, amplitude=0.4, seed=58))
    rng = np.random.default_rng(57)
    q = rng.standard_normal((SPLAT_N, 4))
    b.add_shape_gaussian(
        -1, means=np.c_[rng.uniform(mid - 6, mid + 6, (SPLAT_N, 2)),
                        rng.uniform(0.3, 1.5, SPLAT_N)],
        scales=rng.uniform(0.05, 0.3, (SPLAT_N, 3)),
        quats=q / np.linalg.norm(q, axis=1, keepdims=True),
        colors=rng.uniform(0.0, 1.0, (SPLAT_N, 3)),
        opacities=rng.uniform(0.3, 0.9, SPLAT_N), key="splats")
    return b


class CameraAnt:
    """Phase 56's loop on the port: ``frame(state)`` draws a uniform
    mjc:ctrl in [-1, 1], steps SUBSTEPS substeps of SolverMuJoCo(
    iterations=8, euler) through the static pipeline, places every world's
    track camera and renders it; nothing reads a value back to the host.

    The track camera (ant.xml's ``mode="trackcom"``) sits at the torso's
    position plus (0, -3, 0.3) with a fixed orientation looking along +Y;
    MuJoCo follows the subtree's centre of mass, this follows the torso
    body."""

    def __init__(self, nt, model, n, device, seed=56):
        import numpy as np
        import torch
        from newton_tpu_torch.sensors import SensorTiledCamera
        st = model.structure
        self.nt, self.model, self.n = nt, model, n
        self.pipe = nt.CollisionPipeline(model)
        self.solver = nt.SolverMuJoCo(model, iterations=ITERS,
                                      integrator="euler")
        self.cam = SensorTiledCamera(model, width=CAM_RES, height=CAM_RES,
                                     fov_y=CAM_FOV)
        torso = np.nonzero(np.asarray(st.body_key) == "torso")[0]
        shape = np.nonzero(np.asarray(st.shape_key) == "torso_geom")[0]
        if len(torso) != n or len(shape) != n:
            raise AssertionError(f"camera ant: {len(torso)} torsos, "
                                 f"{len(shape)} torso geoms in {n} worlds")
        self.torso = torch.as_tensor(torso, device=device)
        self.torso_shape = torch.as_tensor(shape, device=device)
        self.offset = torch.tensor(CAM_OFFSET, device=device)
        self.quat = torch.tensor(CAM_QUAT, device=device).expand(n, 4)
        self.ctl = model.control()
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)
        self.A = st.mjc_actuation.n

    def start(self):
        m = self.model
        return self.solver.init_state(self.nt.eval_fk(
            m, m.joint_q0, m.joint_qd0, m.state()))

    def poses(self, state):
        import torch
        return torch.cat([state.body_q[self.torso, 0:3] + self.offset,
                          self.quat], 1)

    def frame(self, state, kernels=True):
        import torch
        self.ctl.custom["mjc:ctrl"] = 2 * torch.rand(
            self.A, generator=self.gen, device=self.gen.device) - 1
        for _ in range(SUBSTEPS):
            state = self.solver.step(state, None, self.ctl,
                                     self.pipe.collide(state), DT,
                                     kernels=kernels)
        return state, self.cam.render(state, self.poses(state))


def torso_pixel(cam):
    """The pixel whose track-camera ray points nearest the torso centre
    (the same pixel in every world): its index in the H W image."""
    import numpy as np
    x, y, z, w = CAM_QUAT
    R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                   2 * (x * z + y * w)],
                  [2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                   2 * (y * z - x * w)],
                  [2 * (x * z - y * w), 2 * (y * z + x * w),
                   1 - 2 * (x * x + y * y)]])
    to_c = -np.asarray(CAM_OFFSET) / np.linalg.norm(CAM_OFFSET)
    d = cam._pixel_dirs.cpu().numpy().astype(np.float64) @ R.T
    return int(np.argmax(d @ to_c))


def torso_gate(loop, state, out, label):
    """The torso pixel shows each world's own torso in CAM_SEEN_SHARE of
    the worlds, at the analytic sphere distance (float64) within
    CAM_DEPTH_TOL."""
    import torch
    n, pix = loop.n, torso_pixel(loop.cam)
    R = loop.cam.width * loop.cam.height
    seen = out["shape_index"].reshape(n, R)[:, pix] == loop.torso_shape
    o, d = loop.cam.rays(loop.poses(state))
    o, d = (x.view(n, R, 3)[:, pix].double() for x in (o, d))
    oc = o - state.body_q[loop.torso, 0:3].double()
    b = (d * oc).sum(-1)
    c = (oc * oc).sum(-1) - CAM_TORSO_R ** 2
    t = -b - torch.sqrt(torch.clamp(b * b - c, min=0.0))
    err = (out["depth"].reshape(n, R)[:, pix].double() - t)[seen].abs()
    g = dict(pixel=pix, seen_share=float(seen.double().mean()),
             depth_err_max=float(err.max()) if err.numel() else None)
    if not (g["seen_share"] >= CAM_SEEN_SHARE
            and g["depth_err_max"] is not None
            and g["depth_err_max"] <= CAM_DEPTH_TOL):
        raise AssertionError(f"{label}: torso gate fails {g}")
    return g


def once_ms(fn):
    """Device time of one call after one untimed call (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1)


def timed_call(fn):
    """(fn(), the device time in ms of that one call), by CUDA events."""
    import torch
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


def analytic_inputs(model, state):
    """closest_analytic's shape operands: (X, scale, class codes) and the
    shapes of each class (plane, sphere, box, capsule)."""
    import numpy as np
    import torch
    from newton_tpu_torch.geometry import raycast
    cls = raycast.shape_classes(model)
    counts = tuple(int((cls == k).sum()) for k in range(4))
    return (raycast.shape_world_transforms(model, state), model.shape_scale,
            torch.as_tensor(cls, device=state.body_q.device), counts)


def k1_compare(o, d, X, sc, cls, max_dist, label):
    """K1 against its plain twin on the same inputs: t, shape index and
    normal equal bit for bit (culling must not change the first minimum;
    the errors and ties, t within CAM_T_TOL max(1, t), normals within
    CAM_N_TOL, the same shape except where the two shapes' t differ by
    less than CAM_T_TOL, are reported beside). The result also holds the
    plain twin's device time on this (its only) run."""
    import torch
    from newton_tpu_torch.geometry import raycast
    tk, sk, nk = raycast.closest_analytic(o, d, X, sc, cls, max_dist)
    (tp, sp, np_), plain_ms = timed_call(
        lambda: raycast.closest_analytic_plain(o, d, X, sc, cls, max_dist))
    same = sk == sp
    ties = 0
    for r in torch.nonzero(~same).flatten().tolist()[:100]:
        ts = []
        for s in (int(sk[r]), int(sp[r])):
            if s < 0:
                ts.append(float("inf"))
                continue
            t, _, _ = raycast.closest_analytic_plain(
                o[r:r + 1], d[r:r + 1], X[s:s + 1], sc[s:s + 1],
                cls[s:s + 1], max_dist)
            ts.append(float(t[0]))
        ties += abs(ts[0] - ts[1]) < CAM_T_TOL * max(1.0, ts[1])
    mism = int((~same).sum())
    both = same & (sp >= 0)
    t_err = float((tk - tp)[both].abs().max()) if both.any() else 0.0
    t_ok = bool(((tk - tp)[both].abs()
                 <= CAM_T_TOL * torch.clamp(tp[both], min=1.0)).all())
    n_err = float((nk - np_)[both].abs().max()) if both.any() else 0.0
    res = dict(rays=o.shape[0], shapes=X.shape[0], hits=int(both.sum()),
               t_max_abs_err=t_err, n_max_abs_err=n_err,
               shape_mismatches=mism, ties=int(ties),
               bit_equal=bool(torch.equal(tk, tp) and torch.equal(sk, sp)
                              and torch.equal(nk, np_)),
               plain_ms=plain_ms)
    if not (t_ok and n_err <= CAM_N_TOL and mism == ties
            and res["bit_equal"]):
        raise AssertionError(f"{label}: K1 vs plain not bit-equal {res}")
    return res, (tp, sp, np_)


def camera_rows(n_cam, res, n_rays, dev):
    """Indices of n_rays rays of the (n_cam res res) camera-major rays:
    whole image rows of 64 cameras spread over the grid of worlds (every
    n_cam / 64-th), each at its own row, so that the kernel's warps keep
    half a row each as on the main path."""
    import torch
    k = n_rays // res
    cams = torch.arange(k, device=dev) * max(1, n_cam // k) % n_cam
    rows = torch.arange(k, device=dev) * 23 % res
    base = (cams * res + rows) * res
    return (base[:, None] + torch.arange(res, device=dev)).reshape(-1)


def k1_parity(dev):
    """K1 against its plain twin on the ant x CAM_PARITY_W scene after two
    frames (R = 65,536 rays, S = 224 shapes): the track cameras' rays, and
    the shadow rays from the plain result's hits toward the light; both
    timed."""
    import torch
    import newton_tpu_torch as nt
    from newton_tpu_torch.geometry import raycast
    model = camera_ant_scene(nt, CAM_PARITY_W).finalize(dev)
    loop = CameraAnt(nt, model, CAM_PARITY_W, dev, seed=57)
    state = loop.start()
    for _ in range(2):
        state, _ = loop.frame(state)
    o, d = loop.cam.rays(loop.poses(state))
    X, sc, cls, counts = analytic_inputs(model, state)
    md = loop.cam.max_dist
    out = dict(class_counts=counts)
    out["primary"], (tp, sp, np_) = k1_compare(o, d, X, sc, cls, md,
                                               "K1 primary")
    out["plain_ms"] = out["primary"].pop("plain_ms")
    out["work"] = {}
    raycast.closest_analytic(o, d, X, sc, cls, md, stats=out["work"])
    out["ms"] = time_ms(lambda: raycast.closest_analytic(o, d, X, sc, cls,
                                                         md), n=10,
                        queued=True)
    so = o + d * tp[:, None] + np_ * 1e-3
    sd = (-loop.cam._light).expand_as(so)
    out["shadow"], _ = k1_compare(so, sd, X, sc, cls, md, "K1 shadow")
    return out


def phase_camera_ant(dev):
    """Phase 56 (see the module docstring). Returns (results, (model,
    loop, state)) for phase 57."""
    import torch
    import newton_tpu_torch as nt
    from newton_tpu_torch.geometry import bvh, raycast
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = camera_ant_scene(nt, CAM_W).finalize(dev)
    loop = CameraAnt(nt, model, CAM_W, dev)
    state = loop.start()
    torch.cuda.synchronize()
    label = f"camera ant x {CAM_W}"
    res = dict(worlds=CAM_W, cameras=CAM_W, rays=CAM_W * CAM_RES ** 2,
               shapes=model.structure.shape_count,
               setup_s=time.perf_counter() - t0)
    state, out = loop.frame(state)
    torch.cuda.synchronize()
    reset_robot_launches()
    raycast.closest_analytic.launches = 0
    bvh.mesh_closest.launches = 0
    t0 = time.perf_counter()
    for _ in range(CAM_FRAMES):
        state, out = loop.frame(state)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    n_sub = CAM_FRAMES * SUBSTEPS
    launches = gen_launches() + (raycast.closest_analytic.launches,
                                 bvh.mesh_closest.launches)
    if launches != (n_sub, n_sub, 0, CAM_FRAMES, 0):
        raise AssertionError(f"{label}: launches (B1, B1 solve, B2, K1, K2) "
                             f"{launches} in {n_sub} substeps and "
                             f"{CAM_FRAMES} renders")
    gates = rigid_gates(state, label)
    for k in ("depth", "normal", "color", "albedo", "hdr"):
        if not bool(torch.isfinite(out[k]).all()):
            raise AssertionError(f"{label}: non-finite {k}")
    gates.update(torso_gate(loop, state, out, label))
    gates["hit_share"] = float((out["shape_index"] >= 0).double().mean())
    res.update(frames=CAM_FRAMES, substeps=n_sub, launches=launches,
               gates=gates, env_steps_per_s=n_sub * CAM_W / elapsed,
               frame_ms=elapsed * 1e3 / CAM_FRAMES)
    poses = loop.poses(state)
    res["render_ms"] = time_ms(lambda: loop.cam.render(state, poses), n=3)
    o, d = loop.cam.rays(poses)
    X, sc, cls, counts = analytic_inputs(model, state)
    md = loop.cam.max_dist
    sub = camera_rows(CAM_W, CAM_RES, CAM_PLAIN_RAYS, dev)
    os_, ds_ = o[sub].contiguous(), d[sub].contiguous()
    # K1 against its twin at the main path's shapes (S = 14,336, the
    # 1,024 coincident floors) on rows of 64 cameras across the grid
    cmp, _ = k1_compare(os_, ds_, X, sc, cls, md, f"{label}: K1")
    if not cmp["hits"]:
        raise AssertionError(f"{label}: K1 vs plain saw no hit {cmp}")
    work = {}
    raycast.closest_analytic(o, d, X, sc, cls, md, stats=work)
    # timed with the stream held busy (the device's time, pre-pass
    # included) and back to back (the pre-pass's host dispatch included)
    res["k1"] = dict(
        rays=o.shape[0], shapes=X.shape[0], class_counts=counts, work=work,
        ms=time_ms(lambda: raycast.closest_analytic(o, d, X, sc, cls, md),
                   n=3, queued=True),
        ms_unqueued=time_ms(lambda: raycast.closest_analytic(
            o, d, X, sc, cls, md), n=3),
        plain_rays=CAM_PLAIN_RAYS, plain_ms=cmp.pop("plain_ms"),
        compare=cmp,
        ms_on_plain_rays=time_ms(lambda: raycast.closest_analytic(
            os_, ds_, X, sc, cls, md), n=10, queued=True))
    _, syncs = count_syncs(lambda: loop.frame(state))
    res.update(host_syncs_per_frame=syncs, sync_sites=list(SYNC_SITES))
    if syncs:
        raise AssertionError(f"{label}: {syncs} host syncs a frame: "
                             f"{SYNC_SITES}")
    prof = profile_frame(lambda: loop.frame(state), SUBSTEPS)
    res.update(profile=prof, busy_share_unprofiled=busy_unprofiled(
        prof, CAM_W, res["env_steps_per_s"]))
    if prof is not None:
        res["device_ms_per_frame"] = prof["device_busy_ms"]
        res["device_ops_per_frame"] = prof["device_ops"]
    res["parity"] = k1_parity(dev)
    res["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    return res, (model, loop, state)


def golden_scene(lib, which):
    """tests/test_sensors.py:63-87's sphere and box (``"sphere_box"``) or
    tools/gen_golden_camera_mesh.py's icosahedron mesh and box
    (``"mesh"``), each over a ground plane."""
    import numpy as np
    b = lib.ModelBuilder()
    if which == "sphere_box":
        body = b.add_body(xform=[0, 0, 0.5, 0, 0, 0, 1])
        b.add_shape_sphere(body, radius=0.5)
        b.add_joint_free(body)
        box = b.add_body(xform=[1.2, 0, 0.25, 0, 0, 0, 1])
    else:
        phi = (1.0 + np.sqrt(5.0)) / 2.0
        v = np.array([[-1, phi, 0], [1, phi, 0], [-1, -phi, 0],
                      [1, -phi, 0], [0, -1, phi], [0, 1, phi], [0, -1, -phi],
                      [0, 1, -phi], [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1],
                      [-phi, 0, 1]], dtype=np.float64)
        v *= 0.5 / np.linalg.norm(v[0])
        f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10],
                      [0, 10, 11], [1, 5, 9], [5, 11, 4], [11, 10, 2],
                      [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2], [3, 2, 6],
                      [3, 6, 8], [3, 8, 9], [4, 9, 5], [2, 4, 11], [6, 2, 10],
                      [8, 6, 7], [9, 8, 1]], dtype=np.int32)
        mb = b.add_body(xform=[0.0, 0.0, 0.6, 0, 0, 0, 1])
        b.add_shape_mesh(mb, mesh=lib.Mesh(v, f.reshape(-1),
                                           compute_inertia=False))
        b.add_joint_free(mb)
        box = b.add_body(xform=[1.1, 0.2, 0.25, 0, 0, 0, 1])
    b.add_shape_box(box, hx=0.25, hy=0.25, hz=0.25)
    b.add_joint_free(box)
    b.add_ground_plane()
    return b


GOLDEN_CAM_MESH = (0.0, -3.0, 1.6, 0.42, 0.0, 0.0, 0.9075)


def golden_render(dev, which, golden_dir):
    """Render a golden scene at 48 x 32 as tests/test_sensors.py does and
    hold it to the stored image with that test's gates: shape-index match
    > 0.98, median depth error < 5e-3 (and color error < 0.02 on the mesh
    scene, rendered with shadows)."""
    import numpy as np
    import newton_tpu_torch as nt
    from newton_tpu_torch.sensors import SensorTiledCamera
    name = ("camera_sphere_box.npz" if which == "sphere_box"
            else "camera_mesh_scene.npz")
    gold = np.load(os.path.join(golden_dir, name))
    m = golden_scene(nt, which).finalize(dev)
    s = nt.eval_fk(m, m.joint_q0, m.joint_qd0, m.state())
    if which == "sphere_box":
        cam = SensorTiledCamera(m, width=48, height=32)
        xf = gold["cam_xform"]
    else:
        cam = SensorTiledCamera(m, width=48, height=32, shadows=True,
                                light_dir=(0.3, 0.2, -0.9))
        xf = np.asarray(GOLDEN_CAM_MESH, np.float32)
    out = cam.render(s, np.asarray(xf, np.float32)[None])
    sidx = out["shape_index"][0].cpu().numpy()
    depth = out["depth"][0].cpu().numpy()
    both = (sidx >= 0) & (gold["shape_index"] >= 0)
    g = dict(shape_match=float((sidx == gold["shape_index"]).mean()),
             depth_err_median=float(np.median(np.abs(
                 depth - gold["depth"])[both])))
    ok = g["shape_match"] > 0.98 and g["depth_err_median"] < 5e-3
    if which == "mesh":
        g["color_err"] = float(np.abs(out["color"][0].cpu().numpy()
                                      - gold["color"]).mean())
        ok = ok and g["color_err"] < 0.02
    if not ok:
        raise AssertionError(f"golden {which}: gates fail {g}")
    return g


def png_size(path):
    """(width, height) of a PNG whose pixels decompress to that size."""
    import struct
    import zlib
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path}: not a PNG")
    w, h = struct.unpack(">II", data[16:24])
    pos, idat = 8, b""
    while pos < len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    if len(zlib.decompress(idat)) != h * (1 + 3 * w):
        raise AssertionError(f"{path}: pixel data of the wrong size")
    return w, h


def camera_viewers(dev, model, loop, state):
    """(f): ViewerRTX writes a decodable PNG of world 0's ant, picking from
    a torso's camera returns that torso in three worlds, ViewerFile
    records 2 frames."""
    import tempfile
    import numpy as np
    from newton_tpu_torch.viewer import ViewerFile, ViewerNull, ViewerRTX
    out = {}
    torso = state.body_q[loop.torso, 0:3].cpu().numpy().astype(np.float64)
    with tempfile.TemporaryDirectory() as tmp:
        v = ViewerRTX(out_dir=tmp, width=160, height=120,
                      cam_pos=torso[0] + [2.0, -2.5, 1.2],
                      cam_target=torso[0])
        v.set_model(model)
        v.begin_frame(0.0)
        v.log_state(state)
        v.end_frame()
        out["rtx_png"] = png_size(os.path.join(tmp, "frame_00000.png"))
        out["rtx_lit_share"] = float((v.last_image.max(-1) > 0.05).mean())
        if out["rtx_png"] != (160, 120) or out["rtx_lit_share"] <= 0.0:
            raise AssertionError(f"ViewerRTX: {out}")
        path = os.path.join(tmp, "rec.json")
        rec = ViewerFile(path)
        rec.set_model(model)
        for k in range(2):
            rec.begin_frame(k * SUBSTEPS * DT)
            rec.log_state(state)
            rec.end_frame()
        rec.save()
        data = ViewerFile.load(path)
        out["file_frames"] = len(data["frames"])
        if out["file_frames"] != 2 or \
                data["header"]["shape_count"] != model.structure.shape_count:
            raise AssertionError(f"ViewerFile: {out}")
    pick = ViewerNull()
    pick.set_model(model)
    tshape = loop.torso_shape.cpu().numpy()
    out["pick"] = []
    for w in sorted({0, loop.n // 2, loop.n - 1}):
        eye = torso[w] + np.asarray(CAM_OFFSET)
        s, t = pick.pick(state, eye, -np.asarray(CAM_OFFSET)
                         / np.linalg.norm(CAM_OFFSET))
        out["pick"].append((w, s, t))
        if s != int(tshape[w]):
            raise AssertionError(f"pick from world {w}'s camera: shape {s}, "
                                 f"want its torso {int(tshape[w])}")
    return out


def terrain_view(model, body_q):
    """Phase 57 (a)-(d)'s state of the extras scene ``model`` with the main
    path's bodies at body_q, and its track cameras."""
    import dataclasses
    from newton_tpu_torch.sensors import SensorTiledCamera
    state = dataclasses.replace(model.state(), body_q=body_q.clone())
    return state, SensorTiledCamera(model, width=CAM_RES, height=CAM_RES,
                                    fov_y=CAM_FOV)


def k2_operands(model, state, o, d, dev):
    """K2's operands at phase 57 (a), from the extras scene and its rays
    (o, d): the mesh shapes' BVH pool, BVH of each shape, transforms and
    scales, and the K2_RAYS rays (every step-th) its plain twin takes."""
    from newton_tpu_torch.geometry import raycast
    X, sc, _, _ = analytic_inputs(model, state)
    sel, bvh_of, pool = raycast._tables(model, dev)["mesh"]
    step = o.shape[0] // K2_RAYS
    return (pool, bvh_of, X[sel], sc[sel], o[::step].contiguous(),
            d[::step].contiguous())


def phase_camera_paths(dev, main):
    """Phase 57 (see the module docstring)."""
    import torch
    import newton_tpu_torch as nt
    from newton_tpu_torch.geometry import bvh, raycast
    from newton_tpu_torch.sensors import SensorTiledCamera
    model0, loop, state0 = main
    label = "camera paths"
    res = {}
    # (b) shadows on the main path's scene: K1 twice a render
    shad = SensorTiledCamera(model0, width=CAM_RES, height=CAM_RES,
                             fov_y=CAM_FOV, shadows=True)
    poses = loop.poses(state0)
    raycast.closest_analytic.launches = 0
    lit, dark = loop.cam.render(state0, poses), shad.render(state0, poses)
    torch.cuda.synchronize()
    res["shadows"] = dict(
        k1_launches=raycast.closest_analytic.launches,
        ms=once_ms(lambda: shad.render(state0, poses)),
        hdr_mean=float(dark["hdr"].mean()),
        hdr_mean_unshadowed=float(lit["hdr"].mean()))
    if res["shadows"]["k1_launches"] != 3 or not \
            res["shadows"]["hdr_mean"] < res["shadows"]["hdr_mean_unshadowed"]:
        raise AssertionError(f"{label}: shadows {res['shadows']}")
    # K1 against its twin on the shadow rays of rows of 64 cameras, made
    # as the camera makes them (misses too: their origin lies 1e10 away)
    sub = camera_rows(CAM_W, CAM_RES, CAM_PLAIN_RAYS, dev)
    o, d = (x[sub].contiguous() for x in loop.cam.rays(poses))
    X0, sc0, cls0, _ = analytic_inputs(model0, state0)
    t, _, n = raycast.closest_analytic(o, d, X0, sc0, cls0, shad.max_dist)
    so = o + d * t[:, None] + n * 1e-3
    sd = (-shad._light).expand_as(so).contiguous()
    res["shadows"]["k1_compare"], _ = k1_compare(
        so, sd, X0, sc0, cls0, shad.max_dist, f"{label}: K1 shadow rays")
    # (a), (c), (d): the terrain mesh, the heightfield, the splat cloud
    t0 = time.perf_counter()
    model = camera_extras_scene(nt, CAM_W).finalize(dev)
    st = model.structure
    keys = list(st.shape_key)
    mesh_s, hf_s = keys.index("terrain_mesh"), keys.index("heightfield")
    if st.shape_sdf_id[mesh_s] >= 0 or st.shape_sdf_id[hf_s] < 0:
        raise AssertionError(f"{label}: bakes {st.shape_sdf_id[mesh_s]}, "
                             f"{st.shape_sdf_id[hf_s]}")
    state, cam = terrain_view(model, state0.body_q)
    res["setup_s"] = time.perf_counter() - t0
    raycast.closest_analytic.launches = 0
    bvh.mesh_closest.launches = 0
    t0 = time.perf_counter()
    out = cam.render(state, poses)
    torch.cuda.synchronize()
    res["first_render_s"] = time.perf_counter() - t0
    sidx = out["shape_index"]
    res.update(
        launches=(raycast.closest_analytic.launches,
                  bvh.mesh_closest.launches),
        mesh_pixels=int((sidx == mesh_s).sum()),
        heightfield_pixels=int((sidx == hf_s).sum()),
        splat_alpha_max=float(out["splat_alpha"].max()),
        splat_alpha_min=float(out["splat_alpha"].min()),
        render_ms=once_ms(lambda: cam.render(state, poses)))
    for k in ("depth", "normal", "color", "splat_alpha"):
        if not bool(torch.isfinite(out[k]).all()):
            raise AssertionError(f"{label}: non-finite {k}")
    if not (res["launches"] == (1, 1) and res["mesh_pixels"] > 0
            and res["heightfield_pixels"] > 0
            and res["splat_alpha_max"] > 0.3
            and res["splat_alpha_min"] == 0.0):
        raise AssertionError(f"{label}: {res}")
    o, d = cam.rays(poses)
    X, sc, cls, counts = analytic_inputs(model, state)
    cmp, _ = k1_compare(o[sub].contiguous(), d[sub].contiguous(), X, sc,
                        cls, cam.max_dist, f"{label}: K1 with the extras")
    res["k1"] = dict(rays=o.shape[0], shapes=X.shape[0], class_counts=counts,
                     compare=cmp,
                     ms=time_ms(lambda: raycast.closest_analytic(
                         o, d, X, sc, cls, cam.max_dist), n=3, queued=True))
    # K2 at the render's shape, its plain twin on every 64th ray, both
    # against every triangle on K2_BRUTE_RAYS of those
    pool, bvh_of, Xm, scm, os_, ds_ = k2_operands(model, state, o, d, dev)
    stats = {}
    bvh.mesh_closest(pool, o, d, bvh_of, Xm, scm, stats=stats)
    k2 = dict(rays=o.shape[0], mesh_shapes=int(bvh_of.shape[0]),
              triangles=int(pool.mask.sum()),
              leaf_slots=int(pool.mask.numel()), nodes=int(pool.lo.shape[0]),
              leaf_budget=pool.leaf_budget, depth=int(pool.params_np[0, 3]),
              vertices=int(pool.verts.shape[0]), visited=stats,
              ms=time_ms(lambda: bvh.mesh_closest(pool, o, d, bvh_of, Xm,
                                                  scm), n=3))
    sub_stats = {}
    tk, nk = bvh.mesh_closest(pool, os_, ds_, bvh_of, Xm, scm,
                              stats=sub_stats)
    tp, np_ = bvh.mesh_closest_plain(pool, os_, ds_, bvh_of, Xm, scm)
    hit = tp < 1e10
    k2.update(
        plain_rays=os_.shape[0], plain_visited=sub_stats,
        plain_ms=once_ms(lambda: bvh.mesh_closest_plain(
            pool, os_, ds_, bvh_of, Xm, scm)),
        ms_on_plain_rays=time_ms(lambda: bvh.mesh_closest(
            pool, os_, ds_, bvh_of, Xm, scm), n=10),
        plain_hits=int(hit.sum()),
        hits_agree=bool(torch.equal(hit, tk < 1e10)),
        t_max_abs_err=float((tk - tp)[hit].abs().max()),
        n_max_abs_err=float((nk - np_)[hit[..., None].expand_as(nk)]
                            .abs().max()),
        bit_equal=bool(torch.equal(tk, tp) and torch.equal(nk, np_)),
        info=k2_info(), ptxas=ptxas_lines("raycast_mesh_kernel"))
    ok = k2["hits_agree"] and k2["n_max_abs_err"] <= CAM_N_TOL and bool(
        ((tk - tp)[hit].abs() <= CAM_T_TOL * torch.clamp(tp[hit], min=1.0))
        .all())
    # brute force: every triangle, in the mesh's (scaled) frame, on half
    # hits and half misses of the plain twin's
    pick = torch.cat([torch.nonzero(hit[0]).flatten()[:K2_BRUTE_RAYS // 2],
                      torch.nonzero(~hit[0]).flatten()[:K2_BRUTE_RAYS // 2]])
    ob, db = bvh._local_rays(os_[pick], ds_[pick], Xm, scm)
    tri = pool.verts[pool.tris[pool.mask.bool()].long()]     # (T, 3, 3)
    best = torch.full((pick.shape[0],), 1e10, device=dev)
    for a in range(0, tri.shape[0], 2048):
        tt, _ = bvh.ray_triangles(ob[0][:, None], db[0][:, None],
                                  tri[None, a:a + 2048, 0],
                                  tri[None, a:a + 2048, 1],
                                  tri[None, a:a + 2048, 2])
        best = torch.minimum(best, tt.amin(1))
    bh = best < 1e10
    k2["brute_rays"] = int(pick.shape[0])
    k2["brute_hits"] = int(bh.sum())
    for name, t in (("kernel", tk[0, pick]), ("plain", tp[0, pick])):
        agree = torch.equal(bh, t < 1e10)
        e = (t - best)[bh].abs()
        k2[f"brute_{name}_t_err"] = float(e.max()) if e.numel() else 0.0
        ok = ok and agree and bool(
            (e <= CAM_T_TOL * torch.clamp(best[bh], min=1.0)).all())
    res["k2"] = k2
    if not ok:
        raise AssertionError(f"{label}: K2 vs plain or brute force {k2}")
    # (e) the golden scenes, (f) the viewers
    golden = os.path.join(HERE, "tests", "golden_data")
    res["golden"] = {w: golden_render(dev, w, golden)
                     for w in ("sphere_box", "mesh")}
    res["viewers"] = camera_viewers(dev, model0, loop, state0)
    res["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    return res


def camera_kernel_entries(cam, paths):
    """The kernels line's entries of phases 56-57: K1 at the main path's
    shape and at the parity scene's, K2 at phase 57 (a)'s."""
    no_library = ("no single PyTorch call computes this function: {}")
    src = dict(route="cuda", source="newton_tpu_torch/csrc/raycast.cu",
               library_ms=None)
    k1, par, k2 = cam["k1"], cam["parity"], paths["k2"]
    k1_none = ("none: no TPU kernel; newton_tpu/geometry/raycast.py:121 "
               "raycast_model's dense analytic classes (XLA-fused)")
    k1_lib = no_library.format("the closest hit over shapes of several "
                               "classes")
    return [
        dict(name=f"raycast_closest (K1) ant x {CAM_W} track cameras "
                  f"R={k1['rays']} S={k1['shapes']}", **src,
             replaces=k1_none, library=k1_lib,
             path=f"camera ant x {CAM_W}, one render a frame (phase 56, "
                  "the main path)",
             launches=cam["launches"][3],
             max_abs_err=k1["compare"]["t_max_abs_err"],
             ties=k1["compare"]["ties"], ms=k1["ms"],
             ms_unqueued=k1["ms_unqueued"],
             plain_ms=k1["plain_ms"], plain_rays=k1["plain_rays"],
             ms_on_plain_rays=k1["ms_on_plain_rays"],
             work=k1["work"], **k1_bounds(k1)),
        dict(name=f"raycast_closest (K1) ant x {CAM_PARITY_W} "
                  f"R={par['primary']['rays']} S={par['primary']['shapes']}",
             **src, replaces=k1_none, library=k1_lib,
             path="K1 against its plain twin (phase 56), off the main path",
             launches=0, max_abs_err=par["primary"]["t_max_abs_err"],
             shadow_max_abs_err=par["shadow"]["t_max_abs_err"],
             ties=(par["primary"]["ties"], par["shadow"]["ties"]),
             ms=par["ms"], plain_ms=par["plain_ms"], work=par["work"],
             **k1_bounds(dict(par, rays=par["primary"]["rays"],
                              shapes=par["primary"]["shapes"]))),
        dict(name=f"raycast_mesh (K2) terrain mesh R={k2['rays']} "
                  f"M={k2['mesh_shapes']} T={k2['triangles']}", **src,
             replaces="none: no TPU kernel; newton_tpu/geometry/bvh.py:164 "
                      "MeshBVH.raycast's vmapped lax.while_loop walk",
             library=no_library.format("a BVH closest-hit walk"),
             path=f"camera ant x {CAM_W} over the terrain mesh, one render "
                  "(phase 57 (a))",
             launches=paths["launches"][1],
             max_abs_err=k2["t_max_abs_err"], ms=k2["ms"],
             plain_ms=k2["plain_ms"], plain_rays=k2["plain_rays"],
             ms_on_plain_rays=k2["ms_on_plain_rays"],
             **bound_fields("raycast_mesh", k2["ms"], R=k2["rays"],
                            M=k2["mesh_shapes"],
                            nodes=k2["visited"]["nodes"],
                            tris=k2["visited"]["triangles"],
                            bvh_nodes=k2["nodes"],
                            leaf_slots=k2["leaf_slots"],
                            vertices=k2["vertices"]))]


def policy_kernel_entries(pol, b1_src, b2_src):
    """The kernels line's entries of phase 54: B1 and B2 at the policy
    ant's shapes (the slice's main path)."""
    from newton_tpu_torch.solvers.generalized import linalg
    path = ("ONNX-policy ant x 4096 through the RL layer, replicate + "
            "step_with_contacts (phase 54, the main path)")
    d = pol["b1"]["d"]
    inst = linalg.kernel_instance(d)
    b2 = pol["b2"]
    c, nl, d2 = b2["shape"]
    return [
        dict(name=f"chol_inv_solve [{inst}] d={d} W={POLICY_W}", **b1_src,
             instance=inst, path=path, launches=pol["launches"][0],
             max_abs_err=pol["substep_paths"]["b1 group 0"][0],
             ms=pol["b1"]["ms"], plain_ms=pol["b1"]["plain_ms"],
             **bound_fields("chol_inv_solve", pol["b1"]["ms"], d=d,
                            W=POLICY_W),
             library_ms=pol["b1"]["library_ms"]),
        dict(name=f"pgs_solve_fused [{b2['instance']}] {b2['shape']} "
                  f"W={POLICY_W}", **b2_src, instance=b2["instance"],
             path=path, launches=pol["launches"][1],
             max_abs_err=b2["lam_err"], ms=b2["ms"],
             plain_ms=b2["plain_ms"],
             **bound_fields("pgs_solve_fused", b2["ms"], c=c, nl=nl, d=d2,
                            W=POLICY_W, iters=ITERS))]


def grad_kernel_entries(grad, gk):
    """The kernels line's entries of phase 58: K3 at the ant's d = 14 (the
    main path) and at its other cases, K4 at the ant's captured operands
    (the main path) and at the humanoid's shape."""
    no_library = ("no single PyTorch call computes this function: {}")
    k3_src = dict(route="cuda",
                  source="newton_tpu_torch/csrc/chol_backward.cu",
                  replaces="none: no TPU kernel; the backward of "
                           "newton_tpu/solvers/generalized/linalg_pallas.py"
                           ":91, which jax.grad reaches through "
                           "batched.py:329,345 (_chol_t, _cho_solve_t)",
                  library="torch.autograd.grad through torch.linalg.solve"
                          "(Mi, [I | rhs])")
    k4_src = dict(route="cuda",
                  source="newton_tpu_torch/csrc/pgs_backward.cu",
                  replaces="none: no TPU kernel; the backward of "
                           "newton_tpu/solvers/generalized/pgs_pallas.py"
                           ":204, which jax.grad reaches through "
                           "batched.py:840-850 and pgs_pallas.py:90",
                  library_ms=None, library=no_library.format(
                      "the VJP of a projected-Jacobi solve"))
    path = (f"ant x {GRAD_W} trained by gradient through SolverMuJoCo "
            "(phase 58, the main path)")
    out = []
    for i, c in enumerate(gk["k3"]):
        e = c["errors"]
        out.append(dict(
            name=f"chol_backward (K3) {c['which']} d={c['d']} W={c['W']}",
            **k3_src, path=path if i == 0 else "K3 against the plain "
            "version's autograd (phase 58 (a)), off the main path",
            launches=grad["launches"]["K3"] if i == 0 else 0,
            max_abs_err=max(e["Mi"]["max_abs_err"], e["rhs"]["max_abs_err"]),
            ms=c["ms"], instance=c["instance"], plain_ms=c["plain_ms"],
            library_ms=c["library_ms"],
            bound_ms=c["bound_ms"], bound_by=c["bound_by"],
            share_of_bound=c["share_of_bound"]))
    from newton_tpu_torch.solvers.generalized import pgs
    times = gk["k4_times"]
    for label, shape, launches in (
            ("ant substep (25, 8, 14)", (25, 8, 14), grad["launches"]["K4"]),
            ("humanoid (32, 17, 23)", (32, 17, 23), 0)):
        ms, plain_ms = times[label]
        c, nl, d = shape
        out.append(dict(
            name=f"pgs_backward (K4) {label} W={K4_W}", **k4_src,
            path=path if launches else "K4 against the plain version's "
            "autograd (phase 58 (b)), off the main path",
            launches=launches, max_abs_err=gk["k4"][label]["worst"],
            error_kind="largest normwise relative error over the inputs' "
                       "gradients, envs of equal halvings",
            ms=ms, plain_ms=plain_ms,
            **bound_fields("pgs_backward", ms, c=c, nl=nl, d=d, W=K4_W,
                           iters=ITERS),
            # beside the bound: the forward that B2 saves for K4 (the
            # design's traffic, not the function's), read once
            saved_forward_bytes=4 * K4_W * pgs.save_floats(c, nl, d, ITERS),
            saved_forward_read_ms=4 * K4_W * pgs.save_floats(c, nl, d, ITERS)
            / PEAK_BYTES_PER_S * 1e3))
    return out


def k1_bounds(k1):
    """K1's bound from the work each ray's own culling left (the bound),
    from the work its warps did (warp_), and with every pair (all_pairs_)."""
    w = k1["work"]
    shape = dict(R=k1["rays"], S=k1["shapes"], boxes=w["groups"] + w["tops"])
    return dict(
        **bound_fields("raycast_closest_culled", k1["ms"], **shape,
                       pairs=w["ray_pairs"], box_tests=w["ray_box_tests"]),
        **bound_fields("raycast_closest_culled", k1["ms"], "warp_", **shape,
                       pairs=w["pairs"], box_tests=w["box_tests"]),
        **bound_fields("raycast_closest", k1["ms"], "all_pairs_",
                       R=k1["rays"], classes=k1["class_counts"]))


def pgs_smem(rec):
    from newton_tpu_torch import _kernels
    args, kw = rec
    return _kernels.lib().pgs_smem_bytes(kw["c"], int(kw["ld"].numel()),
                                         args[0].shape[2])


def kernel_info():
    """Registers per thread and resident blocks per SM of B1 and B2 at each
    main-path shape, and of each kernel of B3, B4 and the binning with its
    shared memory per block (cudaFuncGetAttributes and
    cudaOccupancyMaxActiveBlocksPerMultiprocessor, through the library)."""
    import ctypes
    from newton_tpu_torch import _kernels
    lib = _kernels.lib()
    out = {}
    for label, fn, shape in (
            ("B1 d=14", lib.chol_kernel_info, (14,)),
            ("B1 d=23", lib.chol_kernel_info, (23,)),
            ("B2 (25, 8, 14)", lib.pgs_kernel_info, (25, 8, 14)),
            ("B2 (32, 17, 23)", lib.pgs_kernel_info, (32, 17, 23)),
            ("B2 (192, 17, 23)", lib.pgs_kernel_info, (192, 17, 23)),
            ("B1 d=2", lib.chol_kernel_info, (2,)),
            ("B1 d=45", lib.chol_kernel_info, (45,)),
            ("B1 d=170", lib.chol_kernel_info, (170,)),
            ("B2 (32, 39, 45)", lib.pgs_kernel_info, (32, 39, 45)),
            ("B2 (32, 164, 170)", lib.pgs_kernel_info, (32, 164, 170)),
            ("B2 (192, 40, 48)", lib.pgs_kernel_info, (192, 40, 48)),
            ("B1 d=9", lib.chol_kernel_info, (9,)),
            ("B1 d=6", lib.chol_kernel_info, (6,)),
            ("B2 (16, 6, 9)", lib.pgs_kernel_info, (16, 6, 9)),
            ("B2 (14, 3, 6)", lib.pgs_kernel_info, (14, 3, 6)),
            ("B1 d=21", lib.chol_kernel_info, (21,)),
            ("B2 (32, 8, 14)", lib.pgs_kernel_info, (32, 8, 14)),
            ("B2 (14, 0, 6)", lib.pgs_kernel_info, (14, 0, 6)),
            ("B2 (2, 0, 6)", lib.pgs_kernel_info, (2, 0, 6)),
            ("B1 d=36", lib.chol_kernel_info, (36,)),
            ("B2 (32, 0, 36)", lib.pgs_kernel_info, (32, 0, 36)),
            ("B2 (288, 0, 36)", lib.pgs_kernel_info, (288, 0, 36)),
            ("B1 d=12", lib.chol_kernel_info, (12,)),
            ("B2 (72, 0, 6)", lib.pgs_kernel_info, (72, 0, 6))):
        regs, blocks = ctypes.c_int(0), ctypes.c_int(0)
        _kernels.check(fn(*shape, ctypes.addressof(regs),
                          ctypes.addressof(blocks)), label)
        out[label] = dict(registers=regs.value, blocks_per_sm=blocks.value)
    out.update(k3_info())
    for shape in ((25, 8, 14), (32, 17, 23)):
        regs, blocks = ctypes.c_int(0), ctypes.c_int(0)
        label = f"K4 pgs_backward {shape}"
        _kernels.check(lib.pgs_backward_kernel_info(
            *shape, ITERS, ctypes.addressof(regs), ctypes.addressof(blocks)),
            label)
        out[label] = dict(registers=regs.value, blocks_per_sm=blocks.value,
                          smem_bytes=4 * lib.pgs_backward_scratch_floats(
                              *shape, ITERS))
    for which, label in enumerate(("K1 raycast_closest", *K2_INSTANCES)):
        regs, blocks = ctypes.c_int(0), ctypes.c_int(0)
        _kernels.check(lib.raycast_kernel_info(
            which, ctypes.addressof(regs), ctypes.addressof(blocks)), label)
        out[label] = dict(registers=regs.value, blocks_per_sm=blocks.value)
    for which, label in enumerate(("binning", "B3 tile", "B3 node rows",
                                   "B4 tile")):
        regs, smem, blocks = (ctypes.c_int(0) for _ in range(3))
        _kernels.check(lib.mpm_kernel_info(
            which, ctypes.addressof(regs), ctypes.addressof(smem),
            ctypes.addressof(blocks)), label)
        out[label] = dict(registers=regs.value, smem_bytes=smem.value,
                          blocks_per_sm=blocks.value)
    return out


# ---------------------------------------------------------------------------
# Phase 58: the ant x 4096 trained by gradient through SolverMuJoCo (the
# slice's main path): collide + step_batched under autograd, B1 and B2
# forward, K3 and K4 backward, five Adam steps on open-loop controls.

GRAD_W = 4096
GRAD_FRAMES = 2                       # one ctrl vector a frame
GRAD_STEPS = 5                        # Adam steps
GRAD_LR = 0.05
GRAD_U_COST = 1e-3                    # loss = -mean x + 1e-3 mean(u^2)
GRAD_DROP = 0.08                      # roots start this far into the ground
GRAD_REL_TOL = 1e-3                   # ||g_kernel - g_plain|| / ||g_plain||
GRAD_MEM_LIMIT = 40e9                 # bytes; above it, checkpoint frames
K3_SHAPES = (("chol_inv_solve", 14, 4096), ("chol_inv_solve", 23, 4096),
             ("chol_solve", 6, 8192))
K4_W = 4096
K4_RTOL = 1e-3                        # per case, normwise, kept envs
K3_ATOL, K3_RTOL = 1e-5, 1e-4         # elementwise against the plain VJP


def grad_launches():
    """(B1, B2, K3, K4) launch counts."""
    from newton_tpu_torch.solvers.generalized import linalg, pgs
    return (linalg.chol_inv_solve.launches, pgs.pgs_solve_fused.launches,
            linalg.chol_backward.launches, pgs.pgs_backward.launches)


def reset_grad_launches():
    from newton_tpu_torch.solvers.generalized import linalg, pgs
    reset_robot_launches()
    linalg.chol_backward.launches = 0
    pgs.pgs_backward.launches = 0


def grad_start_state(model, state0, dev, n, seed=58):
    """n ant worlds with perturbed coordinates and velocities, roots
    GRAD_DROP into the ground (contact rows active from the first
    substep)."""
    import numpy as np
    import torch
    import newton_tpu_torch as nt
    rng = np.random.RandomState(seed)
    sb = nt.batch_state(state0, n)
    q = sb.joint_q.cpu().numpy() + 0.02 * rng.randn(*sb.joint_q.shape)
    q[:, 2] -= GRAD_DROP
    qd = sb.joint_qd.cpu().numpy() + 0.1 * rng.randn(*sb.joint_qd.shape)
    return nt.eval_fk(model, torch.as_tensor(q, dtype=torch.float32,
                                             device=dev),
                      torch.as_tensor(qd, dtype=torch.float32, device=dev),
                      sb)


def ant_grad_loss(model, pipe, solver, s0, u, kernels=True, ckpt=False,
                  stats=None):
    """-mean(torso x after GRAD_FRAMES x SUBSTEPS substeps) + GRAD_U_COST
    mean(u^2), u (n, GRAD_FRAMES, A); ``stats``, a dict, gathers each
    substep's worlds with an active contact row (device tensors) and, with
    ``"pgs"`` a list, each substep's B2 operands."""
    import torch

    def frame(s, uf):
        ctl = batched_control(model, uf)
        for _ in range(SUBSTEPS):
            c = pipe.collide(s)
            rec = {} if stats is not None and "pgs" in stats else None
            if stats is not None:
                stats.setdefault("active", []).append(
                    c.rigid_contact_mask.any(1))
            s = solver.step_batched(s, None, ctl, c, DT, kernels=kernels,
                                    record=rec)
            if rec is not None:
                stats["pgs"].append(rec["pgs"])
        return s
    s = s0
    for f in range(u.shape[1]):
        if ckpt:
            import torch.utils.checkpoint as cp
            s = cp.checkpoint(frame, s, u[:, f], use_reentrant=False)
        else:
            s = frame(s, u[:, f])
    return -s.joint_q[:, 0].mean() + GRAD_U_COST * (u * u).mean()


def grad_of(model, pipe, solver, s0, u0, kernels=True, ckpt=False,
            stats=None):
    """(loss, d loss / d u) from u0."""
    import torch
    u = u0.detach().clone().requires_grad_(True)
    loss = ant_grad_loss(model, pipe, solver, s0, u, kernels, ckpt, stats)
    (g,) = torch.autograd.grad(loss, u)
    return loss.detach(), g


def halving_mismatch(records):
    """Worlds whose B2 guard halvings differ between the kernel and the
    plain version on any substep's captured operands (n,) bool."""
    import torch
    from newton_tpu_torch.solvers.generalized import pgs
    bad = None
    with torch.no_grad():
        for args, kw in records:
            args = [a.detach() for a in args]
            kw = {k: (v.detach() if torch.is_tensor(v) else v)
                  for k, v in kw.items()}
            h_k = pgs.pgs_solve_fused(*args, **kw, return_halvings=True)[2]
            h_p = pgs.pgs_solve_fused_plain(*args, **kw,
                                             return_halvings=True)[2]
            d = h_k != h_p
            bad = d if bad is None else bad | d
    return bad


def phase_grad_ant(dev):
    """The gradient-trained ant x GRAD_W: launches per substep, finite
    loss and gradients, the loss falls over GRAD_STEPS Adam steps, kernel
    against plain gradient, bit-equal repeats, host syncs, rates, peak
    memory. Returns (results, the scene and its first substep's B2
    operands for phase 58 (b))."""
    import torch
    t0 = time.perf_counter()
    model, pipe, solver, state0 = build_ant(dev)
    s0 = grad_start_state(model, state0, dev, GRAD_W)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    A = model.structure.mjc_actuation.n
    u0 = 2 * torch.rand((GRAD_W, GRAD_FRAMES, A), generator=gen,
                        device=dev) - 1
    setup_s = time.perf_counter() - t0
    out = dict(worlds=GRAD_W, substeps=GRAD_FRAMES * SUBSTEPS,
               adam_steps=GRAD_STEPS, lr=GRAD_LR, setup_s=setup_s)
    # warm-up and the memory probe: one forward and backward
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    grad_of(model, pipe, solver, s0, u0)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    ckpt = peak > GRAD_MEM_LIMIT
    out["peak_memory_bytes_uncheckpointed"] = peak
    out["checkpointed"] = ckpt
    if ckpt:
        torch.cuda.reset_peak_memory_stats()
        grad_of(model, pipe, solver, s0, u0, ckpt=True)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    out["peak_memory_bytes"] = peak
    # the training run: every count set to 0 just before, read just after
    u = u0.clone().requires_grad_(True)
    opt = torch.optim.Adam([u], lr=GRAD_LR)
    losses, fwd_s, bwd_s, finite, active = [], 0.0, 0.0, True, []
    torch.cuda.synchronize()
    reset_grad_launches()
    t_run = time.perf_counter()
    for _ in range(GRAD_STEPS):
        opt.zero_grad(set_to_none=True)
        stats = {}
        t1 = time.perf_counter()
        loss = ant_grad_loss(model, pipe, solver, s0, u, ckpt=ckpt,
                             stats=stats)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        fwd_s += t2 - t1
        bwd_s += t3 - t2
        losses.append(float(loss.detach()))
        finite &= bool(torch.isfinite(loss)) and bool(
            torch.isfinite(u.grad).all())
        active.append(torch.stack(stats["active"]).float().mean(1))
        opt.step()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    launches = grad_launches()
    with torch.no_grad():
        loss_after = float(ant_grad_loss(model, pipe, solver, s0, u))
    active = torch.stack(active)                     # (steps, substeps)
    n_sub = GRAD_FRAMES * SUBSTEPS
    per_substep = GRAD_STEPS * n_sub
    fwd_b = GRAD_STEPS * n_sub * (2 if ckpt else 1)   # + the recompute
    out.update(
        launches=dict(zip(("B1", "B2", "K3", "K4"), launches)),
        losses=losses, loss_after=loss_after,
        active_world_share=dict(min=float(active.min()),
                                mean=float(active.mean())),
        train_steps_per_s=GRAD_STEPS / run_s,
        env_steps_per_s=GRAD_W * n_sub * GRAD_STEPS / run_s,
        forward_ms=1e3 * fwd_s / GRAD_STEPS,
        backward_ms=1e3 * bwd_s / GRAD_STEPS,
        backward_over_forward=bwd_s / fwd_s)
    gates = dict(
        finite=finite and all(map(lambda v: v == v, losses)),
        loss_falls=loss_after < losses[0],
        launches=launches == (fwd_b, fwd_b, per_substep, per_substep),
        contacts_every_substep=bool((active > 0).all()))
    # kernel against plain gradient from u0 (the plain versions under
    # autograd on the card); worlds whose B2 halvings differ are counted
    # and left out (each world's gradient is its own: the loss is a mean)
    stats = {"pgs": []}
    loss_k, g_k = grad_of(model, pipe, solver, s0, u0, stats=stats)
    _, g_p = grad_of(model, pipe, solver, s0, u0, kernels=False)
    bad = halving_mismatch(stats["pgs"])
    keep = ~bad
    rel = float((g_k[keep] - g_p[keep]).norm() / g_p[keep].norm())
    rel_all = float((g_k - g_p).norm() / g_p.norm())
    worst = ((g_k - g_p).flatten(1).norm(dim=1)
             / g_p.flatten(1).norm(dim=1).clamp(min=1e-30))
    out["kernel_vs_plain"] = dict(
        rel_err=rel, rel_err_all_worlds=rel_all, bound=GRAD_REL_TOL,
        halving_mismatch_worlds=int(bad.sum()),
        worst_world_rel_err=float(worst[keep].max()),
        max_abs_err=float((g_k - g_p).abs().max()))
    gates["kernel_vs_plain"] = rel <= GRAD_REL_TOL
    # repeats: two backward passes from the same u0
    _, g_k2 = grad_of(model, pipe, solver, s0, u0)
    gates["bit_equal_repeat"] = bool(torch.equal(g_k, g_k2))
    out["repeat_max_abs_diff"] = float((g_k - g_k2).abs().max())
    # host syncs: one forward substep under autograd, and one backward
    u = u0.clone().requires_grad_(True)
    ctl = batched_control(model, u[:, 0])

    def one_substep():
        return solver.step_batched(s0, None, ctl, pipe.collide(s0), DT)
    s1, n_fwd = count_syncs(one_substep)
    loss1 = -s1.joint_q[:, 0].mean()
    _, n_bwd = count_syncs(lambda: loss1.backward())
    out["host_syncs"] = dict(forward_substep=n_fwd,
                             backward_of_one_substep=n_bwd,
                             backward_sites=list(SYNC_SITES[:4]))
    gates["no_sync_forward"] = n_fwd == 0
    # one profiled train step (forward + backward) from u0: device time,
    # operations, busy share, and the kernels' share of device time
    prof = profile_frame(lambda: grad_of(model, pipe, solver, s0, u0), n_sub)
    if prof is not None:
        step_ms = 1e3 / out["train_steps_per_s"]
        top = prof["top_kernels_ms"]
        out["profile"] = dict(
            device_ms_per_train_step=prof["device_busy_ms"],
            device_ops_per_train_step=prof["device_ops"],
            wall_ms_profiled=prof["wall_ms"],
            busy_share_unprofiled=prof["device_busy_ms"] / step_ms,
            memcpy=(prof["memcpy_dtoh"], prof["memcpy_htod"]),
            top_kernels_ms=top,
            k3_k4_share=sum(v for k, v in top.items()
                            if "backward_kernel" in k)
            / prof["device_busy_ms"])
    out["gates"] = gates
    if not all(gates.values()):
        raise AssertionError(f"phase 58: gates {gates}; {out}")
    return out, (model, pipe, solver, stats["pgs"][0])


def k3_operands(dev, d, n):
    """Phase 58 (a)'s operands of a K3 case at d, W = n, from seed 580 +
    d: (Mi (n, d, d) SPD, rhs, gx (n, d), gMinv (n, d, d))."""
    import numpy as np
    import torch
    rng = np.random.RandomState(580 + d)
    A = rng.randn(n, d, d).astype(np.float32)
    spd = A @ np.transpose(A, (0, 2, 1)) + 2.0 * np.eye(d, dtype=np.float32)
    Mi = torch.as_tensor(spd, device=dev)
    rhs = torch.as_tensor(rng.randn(n, d).astype(np.float32), device=dev)
    gx = torch.as_tensor(rng.randn(n, d).astype(np.float32), device=dev)
    gM = torch.as_tensor(rng.randn(n, d, d).astype(np.float32), device=dev)
    return Mi, rhs, gx, gM


def k3_case(dev, which, d, n):
    """K3 against autograd of the plain version (float32, the card) and of
    a float64 one: elementwise and normwise errors, and the times of K3,
    the plain backward and torch.linalg.solve's backward."""
    import torch
    from newton_tpu_torch.solvers.generalized import linalg
    Mi, rhs, gx, gM = k3_operands(dev, d, n)
    inv = which == "chol_inv_solve"

    def vjp(fn, Mi, rhs, gx, gM):
        Mi = Mi.detach().requires_grad_(True)
        rhs = rhs.detach().requires_grad_(True)
        out = fn(Mi, rhs)
        outs, cots = ((out[0], out[1]), (gM, gx)) if inv else ((out,), (gx,))
        return torch.autograd.grad(outs, (Mi, rhs), cots)
    k_fn = linalg.chol_inv_solve if inv else linalg.chol_solve
    p_fn = linalg.chol_inv_solve_plain if inv else linalg.chol_solve_plain
    before = linalg.chol_backward.launches
    gk = vjp(k_fn, Mi, rhs, gx, gM)
    torch.cuda.synchronize()
    launched = linalg.chol_backward.launches - before
    gp = vjp(p_fn, Mi, rhs, gx, gM)
    g64 = vjp(p_fn, Mi.double(), rhs.double(), gx.double(), gM.double())
    ok = True
    errs = {}
    for name, a, b, r in zip(("Mi", "rhs"), gk, gp, g64):
        o, e = close(a, b, K3_ATOL, K3_RTOL)
        ek = float(((a.double() - r).flatten(1).norm(dim=1)
                    / r.flatten(1).norm(dim=1)).max())
        ep = float(((b.double() - r).flatten(1).norm(dim=1)
                    / r.flatten(1).norm(dim=1)).max())
        ok &= o and ek <= max(2 * ep, 1e-6)
        errs[name] = dict(max_abs_err=e, normwise_kernel=ek,
                          normwise_plain=ep)
    if launched != 1 or not ok:
        raise AssertionError(f"K3 {which} d={d}: launches {launched}, "
                             f"{errs}")
    # times: K3 alone, the plain backward alone, torch.linalg.solve's
    if inv:
        Minv, x = linalg.chol_inv_solve(Mi, rhs)
        ms = time_ms(lambda: linalg.chol_backward(Minv, x, gx, gM),
                     queued=True)
    else:
        x = linalg.chol_solve(Mi, rhs)
        grhs = linalg.chol_solve(Mi, gx)
        ms = time_ms(lambda: linalg.chol_backward(None, x, None, None, grhs),
                     queued=True)
    M_ = Mi.detach().requires_grad_(True)
    r_ = rhs.detach().requires_grad_(True)
    out = p_fn(M_, r_)
    outs, cots = ((out[0], out[1]), (gM, gx)) if inv else ((out,), (gx,))
    plain_ms = time_ms(lambda: torch.autograd.grad(
        outs, (M_, r_), cots, retain_graph=True), n=5)
    B = solve_operand(Mi, rhs) if inv else rhs[:, :, None]
    M2 = Mi.detach().requires_grad_(True)
    B2 = B.detach().requires_grad_(True)
    X = torch.linalg.solve(M2, B2)
    G = torch.cat([gM, gx[:, :, None]], 2) if inv else gx[:, :, None]
    library_ms = time_ms(lambda: torch.autograd.grad(
        X, (M2, B2), G, retain_graph=True), queued=True)
    return dict(which=which, d=d, W=n, errors=errs, ms=ms,
                instance=linalg.backward_instance(d),
                plain_ms=plain_ms, library_ms=library_ms,
                **bound_fields("chol_backward", ms, d=d, W=n,
                               inverse=inv))


def k4_case(args, kw, glam, gdqd):
    """K4 against autograd of the plain version on one operand set: the
    envs whose B2 halvings differ from the plain version's (K4 follows
    B2's) are counted and left out; the largest normwise error over the
    inputs' gradients."""
    import torch
    from newton_tpu_torch.solvers.generalized import pgs
    names = ("J", "Minv", "qd", "b", "mu", "lam0")
    diff_idx = (0, 1, 2, 3, 5, 6)

    def vjp(fn):
        ins = [a.detach().clone() for a in args]
        for i in diff_idx:
            ins[i].requires_grad_(True)
        w = kw.get("w_other")
        kw2 = dict(kw)
        if w is not None:
            kw2["w_other"] = w.detach().clone().requires_grad_(True)
        lam, dqd, halv = fn(*ins, **kw2, return_halvings=True)
        wrt = [ins[i] for i in diff_idx] + (
            [kw2["w_other"]] if w is not None else [])
        fwd_finite = (torch.isfinite(lam).all(1)
                      & torch.isfinite(dqd).all(1))
        return (torch.autograd.grad((lam, dqd), wrt, (glam, gdqd)), halv,
                fwd_finite)
    before = pgs.pgs_backward.launches
    gk, hk, fk = vjp(pgs.pgs_solve_fused)
    torch.cuda.synchronize()
    launched = pgs.pgs_backward.launches - before
    gp, hp, _ = vjp(pgs.pgs_solve_fused_plain)
    keep = hk == hp
    errs = {}
    for name, a, b in zip(names + ("w_other",), gk, gp):
        num = (a[keep] - b[keep]).norm()
        den = b[keep].norm().clamp(min=1e-30)
        errs[name] = float(num / den)
    worst = max(errs.values())
    finite_where_plain = bool(all(
        torch.equal(torch.isfinite(a[keep]), torch.isfinite(b[keep]))
        for a, b in zip(gk, gp)))
    # envs of other halvings: finite wherever B2's forward there and the
    # plain gradient are finite (the cone's zero tangent is NaN in both)
    other = ~keep & fk
    finite_elsewhere = bool(all(
        torch.isfinite(a[other])[torch.isfinite(b[other])].all()
        for a, b in zip(gk, gp)))
    return dict(errors=errs, worst=worst, launches=launched,
                halving_mismatch_envs=int((~keep).sum()),
                nan_pattern_equal=finite_where_plain,
                finite_in_other_envs=finite_elsewhere)


def k4_time(args, kw, glam, gdqd):
    """(K4 ms, plain backward ms) at one operand set, K4 given the forward
    that B2 saved there."""
    import torch
    from newton_tpu_torch.solvers.generalized import pgs
    w = kw.get("w_other")
    a = [t.detach() for t in args]
    W, r3, d = a[0].shape
    save = torch.empty((W, pgs.save_floats(kw["c"], int(kw["ld"].numel()),
                                           d, kw["iters"])), device=a[0].device)
    pgs._launch(*a, kw["ld"], w, save=save, **{
        k: kw[k] for k in ("c", "iters", "omega", "use_cone", "diag_scale",
                           "reg")}, symmetric=kw.get("symmetric", True))
    ms = time_ms(lambda: pgs.pgs_backward(
        *a, kw["ld"], w, glam, gdqd, save, c=kw["c"], iters=kw["iters"],
        omega=kw["omega"], use_cone=kw["use_cone"],
        diag_scale=kw["diag_scale"], reg=kw["reg"],
        symmetric=kw.get("symmetric", True)), queued=True)
    ins = [t.clone().requires_grad_(i in (0, 1, 2, 3, 5, 6))
           for i, t in enumerate(a)]
    lam, dqd = pgs.pgs_solve_fused_plain(*ins, **kw)
    wrt = [ins[i] for i in (0, 1, 2, 3, 5, 6)]
    plain_ms = time_ms(lambda: torch.autograd.grad(
        (lam, dqd), wrt, (glam, gdqd), retain_graph=True), n=3)
    return ms, plain_ms


def phase_grad_kernels(dev, ant_rec):
    """Phase 58 (a): K3 against autograd of the plain version at d = 14
    and 23 (W = 4096) and chol_solve's backward at d = 6 (W = 8192); (b):
    K4 on the ant's captured operands, random box and cone, nl = 0,
    w_other, and the humanoid's (32, 17, 23)."""
    import numpy as np
    import torch
    a = [k3_case(dev, which, d, n) for which, d, n in K3_SHAPES]
    cases = {}
    gen = np.random.RandomState(581)

    def cots(args, kw):
        n, r = args[3].shape
        d = args[0].shape[2]
        return (torch.as_tensor(gen.randn(n, r).astype(np.float32),
                                device=dev),
                torch.as_tensor(gen.randn(n, d).astype(np.float32),
                                device=dev))
    args, kw = ant_rec
    args = [t.detach() for t in args]
    kw = {k: (v.detach() if torch.is_tensor(v) else v) for k, v in kw.items()}
    kw.pop("return_halvings", None)
    ant = (args, kw)
    sets = {"ant substep (25, 8, 14)": ant}
    base = dict(iters=ITERS, omega=0.8, diag_scale=1.0, reg=1e-3)
    for label, (c, nl, d, cone, two) in {
            "random box (25, 8, 14)": (25, 8, 14, False, False),
            "random cone (25, 8, 14)": (25, 8, 14, True, False),
            "random nl=0 (25, 0, 14)": (25, 0, 14, False, False),
            "random w_other (25, 8, 14)": (25, 8, 14, False, True),
            "humanoid (32, 17, 23)": (32, 17, 23, False, False)}.items():
        r_args, ld = random_pgs_inputs(dev, c, nl, d, seed=582 + nl + d,
                                       n=K4_W)
        k = dict(base, c=c, ld=ld, use_cone=cone)
        if two:
            k["w_other"] = torch.as_tensor(
                np.abs(gen.rand(K4_W, 3 * c)).astype(np.float32),
                device=dev)
        sets[label] = (list(r_args), k)
    times = {}
    for label, (args, kw) in sets.items():
        glam, gdqd = cots(args, kw)
        res = k4_case(args, kw, glam, gdqd)
        if res["launches"] != 1 or res["worst"] > K4_RTOL or not \
                res["nan_pattern_equal"] or not \
                res["finite_in_other_envs"] or \
                res["halving_mismatch_envs"] > max(K4_W // 1000, 1):
            raise AssertionError(f"K4 {label}: {res}")
        cases[label] = res
        if label.startswith(("ant", "humanoid")):
            times[label] = k4_time(args, kw, glam, gdqd)
    return dict(k3=a, k4=cases, k4_times=times,
                b2_save_bit_equal=b2_save_equal(*sets[
                    "ant substep (25, 8, 14)"]),
                k3_info=k3_info(),
                k3_ptxas={**ptxas_lines("chol_backward_warp"),
                          **ptxas_lines("chol_backward_generic")},
                k4_info=k4_info(), k4_ptxas=ptxas_lines("pgs_backward_kernel"),
                save_bytes_per_train_step=4 * GRAD_W
                * GRAD_FRAMES * SUBSTEPS * pgs_save_floats(ant_rec))


def pgs_save_floats(rec):
    """Floats per env that B2 saves for K4 at a captured call's shape."""
    from newton_tpu_torch.solvers.generalized import pgs
    args, kw = rec
    return pgs.save_floats(kw["c"], int(kw["ld"].numel()),
                           args[0].shape[2], kw["iters"])


def b2_save_equal(args, kw):
    """B2 with its forward saved gives the bits it gives without."""
    import torch
    from newton_tpu_torch.solvers.generalized import pgs
    a = [t.detach() for t in args]
    k = {n: kw[n] for n in ("c", "iters", "omega", "use_cone", "diag_scale",
                            "reg")}
    k["symmetric"] = kw.get("symmetric", True)
    save = torch.empty((a[0].shape[0], pgs_save_floats((a, kw))),
                       device=a[0].device)
    plain = pgs._launch(*a, kw["ld"], kw.get("w_other"), **k)
    saved = pgs._launch(*a, kw["ld"], kw.get("w_other"), save=save, **k)
    return all(torch.equal(x, y) for x, y in zip(plain, saved))


def ptxas_lines(kernel, log=None):
    """{instance: its registers line and its spill line} of the kernel
    instances whose mangled name holds ``kernel``, from the build's
    ptxas.log (or from the report ``log``)."""
    import re
    from newton_tpu_torch import _kernels
    out, name = {}, None
    if log is None:
        with open(os.path.join(os.path.dirname(_kernels.build()),
                               "ptxas.log")) as f:
            log = f.read()
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            name = m.group(1) if kernel in m.group(1) else None
            if name:
                t = re.search(kernel + r"I((?:L[ib]\d+E)+)E", name)
                name = (f"{kernel}<" + ", ".join(re.findall(
                    r"L[ib](\d+)E", t.group(1))) + ">") if t else name
                out[name] = []
        elif name and ("spill" in ln or "registers" in ln):
            out[name].append(ln.strip().replace("ptxas info    : ", ""))
    return out


def k3_info():
    """K3's registers and blocks per SM at phase 58's sizes and at d = 45
    (the generic instance), by instance."""
    import ctypes
    from newton_tpu_torch import _kernels
    from newton_tpu_torch.solvers.generalized import linalg
    lib = _kernels.lib()
    out = {}
    for d in (6, 14, 23, 45):
        regs, blocks = ctypes.c_int(0), ctypes.c_int(0)
        _kernels.check(lib.chol_backward_kernel_info(
            d, ctypes.addressof(regs), ctypes.addressof(blocks)), "K3")
        out[f"K3 chol_backward d={d} ({linalg.backward_instance(d)})"] = \
            dict(registers=regs.value, blocks_per_sm=blocks.value)
    return out


def k2_info():
    """K2's instances' registers and blocks per SM."""
    import ctypes
    from newton_tpu_torch import _kernels
    lib = _kernels.lib()
    out = {}
    for which, label in enumerate(K2_INSTANCES, 1):
        regs, blocks = ctypes.c_int(0), ctypes.c_int(0)
        _kernels.check(lib.raycast_kernel_info(
            which, ctypes.addressof(regs), ctypes.addressof(blocks)), label)
        out[label] = dict(registers=regs.value, blocks_per_sm=blocks.value)
    return out


def k4_info():
    """K4's and B2's save instance's registers and blocks per SM at the
    ant's and the humanoid's shapes."""
    import ctypes
    from newton_tpu_torch import _kernels
    lib = _kernels.lib()
    out = {}
    for shape in ((25, 8, 14), (32, 17, 23)):
        for label, fn, extra in (("K4", lib.pgs_backward_kernel_info,
                                  (ITERS,)),
                                 ("B2 save", lib.pgs_save_kernel_info, ())):
            regs, blocks = ctypes.c_int(0), ctypes.c_int(0)
            _kernels.check(fn(*shape, *extra, ctypes.addressof(regs),
                              ctypes.addressof(blocks)), label)
            out[f"{label} {shape}"] = dict(registers=regs.value,
                                           blocks_per_sm=blocks.value)
    return out


USD_W = 4096                          # the USD ant x 4096 (phase 59)
USD_WARMUP = 2
USD_FRAMES = 20
USD_CKPT_FRAME = 10                   # the checkpoint: after this frame
USD_EFFORT = 150.0                    # joint_f = 150 u on the hinges
USD_PARITY_W = 4                      # worlds held to the CPU port
USD_TOL = {"joint_q": 2e-4, "joint_qd": 5e-3, "body_q": 2e-4}


def usd_ant_scene(lib, source):
    """The USD ant (``assets/ant.usda``, or a .usdc of it) on a ground
    plane, with ``lib``'s builder (``newton_tpu`` or ``newton_tpu_torch``):
    the stage's shapes take conaffinity 0, so that they collide with the
    ground and not with each other, as the MJCF ant's geoms do."""
    b = lib.ModelBuilder()
    cfg = b.default_shape_cfg
    affinity, cfg.conaffinity = cfg.conaffinity, 0
    b.add_usd(source)
    cfg.conaffinity = affinity
    b.add_ground_plane()
    return b


def usd_hinge_forces(model, n, frames, dev, seed=0):
    """(frames, n, D) joint_f: 150 u on the revolute dofs, u uniform in
    [-1, 1] from torch.Generator ``seed``, zero elsewhere."""
    import numpy as np
    import torch
    from newton_tpu_torch.sim.enums import JointType
    st = model.structure
    dofs = [int(st.joint_qd_start[j]) for j in range(st.joint_count)
            if int(st.joint_type[j]) == int(JointType.REVOLUTE)]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    u = 2 * torch.rand((frames, n, len(dofs)), generator=gen,
                       device=dev) - 1
    jf = torch.zeros((frames, n, model.joint_dof_count), device=dev)
    jf[:, :, torch.as_tensor(np.asarray(dofs), device=dev)] = USD_EFFORT * u
    return jf


def usd_controls(model, jf):
    """One batched Control a frame, joint_f from ``jf`` (frames, n, D)."""
    import newton_tpu_torch as nt
    c = model.control()
    n = jf.shape[1]
    return [nt.Control(joint_target_q=c.joint_target_q.expand(n, -1).clone(),
                       joint_target_qd=c.joint_target_qd.expand(n, -1)
                       .clone(), joint_f=f.clone(), custom={})
            for f in jf]


def usd_frame(pipe, solver, state, ctl, kernels=True, record=None):
    """SUBSTEPS substeps of static collide + step_batched."""
    for _ in range(SUBSTEPS):
        state = solver.step_batched(state, None, ctl, pipe.collide(state),
                                    DT, kernels=kernels, record=record)
    return state


def model_diff(a, b):
    """Names of the Model tensors and structure fields where ``a`` and
    ``b`` differ (tensors bit for bit)."""
    import dataclasses
    import numpy as np
    import torch

    def same(x, y):
        if isinstance(x, torch.Tensor):
            return (isinstance(y, torch.Tensor) and x.dtype == y.dtype
                    and torch.equal(x, y))
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            x, y = np.asarray(x), np.asarray(y)
            return x.dtype == y.dtype and np.array_equal(x, y)
        if isinstance(x, dict):
            return (isinstance(y, dict) and x.keys() == y.keys()
                    and all(same(x[k], y[k]) for k in x))
        if isinstance(x, (list, tuple)):
            return (type(x) is type(y) and len(x) == len(y)
                    and all(same(p, q) for p, q in zip(x, y)))
        if dataclasses.is_dataclass(x) or hasattr(x, "__dict__"):
            return type(x) is type(y) and same(vars(x), vars(y))
        return x == y
    out = [f.name for f in dataclasses.fields(a)
           if f.name != "structure"
           and not same(getattr(a, f.name), getattr(b, f.name))]
    sa, sb = vars(a.structure), vars(b.structure)
    return out + [f"structure.{k}" for k in sorted(set(sa) | set(sb))
                  if k not in sa or k not in sb or not same(sa[k], sb[k])]


def stack_worlds(states):
    """One batched State of one-world States (``unbatch_env``'s output)."""
    import dataclasses
    import torch
    first = states[0]
    kw = {}
    for f in dataclasses.fields(first):
        v = getattr(first, f.name)
        if isinstance(v, torch.Tensor):
            kw[f.name] = torch.stack([getattr(s, f.name) for s in states])
        elif f.name == "custom":
            kw[f.name] = {k: torch.stack([s.custom[k] for s in states])
                          for k in v}
    return dataclasses.replace(first, **kw)


def phase_usd_ant(dev):
    """Phase 59 (see the module docstring). Returns (results, the
    EventTracer's report)."""
    import tempfile
    import torch
    import newton_tpu_torch as nt
    from newton_tpu_torch.parallel import unbatch_env
    from newton_tpu_torch.usd import parse_usda, write_usdc
    from newton_tpu_torch.utils.benchmark import EventTracer
    from newton_tpu_torch.utils.checkpoint import (load_state, save_state,
                                                   state_digest)
    from newton_tpu_torch.utils.validation import (check_state_valid,
                                                   nan_sweep)
    usda = os.path.join(nt.ASSET_DIR, "ant.usda")
    tr = EventTracer(sync=True)
    res = dict(worlds=USD_W)
    with tempfile.TemporaryDirectory() as tmp:
        with tr.scope("import"):
            with open(usda) as f:
                root = parse_usda(f.read())
            b_text = usd_ant_scene(nt, usda)
        with tr.scope("usdc round trip"):
            usdc = os.path.join(tmp, "ant.usdc")
            write_usdc(root, usdc)
            b_bin = usd_ant_scene(nt, usdc)
            res["usdc_bytes"] = os.path.getsize(usdc)
        with tr.scope("finalize"):
            model = b_bin.finalize(dev)
            diff = model_diff(model, b_text.finalize(dev))
            if diff:
                raise AssertionError(f"USD ant: the .usdc model differs "
                                     f"from the .usda model in {diff}")
            mjcf = nt.ModelBuilder()
            mjcf.add_mjcf(os.path.join(nt.ASSET_DIR, "ant.xml"))
            counts = dict(bodies=model.body_count,
                          joints=model.structure.joint_count,
                          dofs=model.joint_dof_count)
            res["counts"] = dict(usd=counts, mjcf=dict(
                bodies=mjcf.body_count, joints=mjcf.joint_count,
                dofs=mjcf.joint_dof_count))
            if counts != res["counts"]["mjcf"]:
                raise AssertionError(f"USD ant: counts {res['counts']}")
            pipe = nt.CollisionPipeline(model)
            solver = nt.SolverMuJoCo(model, iterations=ITERS,
                                     integrator="euler")
            state = nt.batch_state(nt.eval_fk(
                model, model.joint_q0, model.joint_qd0, model.state()),
                USD_W)
            ctls = usd_controls(model, usd_hinge_forces(
                model, USD_W, USD_WARMUP + USD_FRAMES + 1, dev))
        res["setup_s"] = sum(c["elapsed"] for c in tr.root["children"])
        with tr.scope("warm-up"):
            for k in range(USD_WARMUP):
                state = usd_frame(pipe, solver, state, ctls[k])
        reset_robot_launches()
        window = [USD_WARMUP, USD_WARMUP + USD_CKPT_FRAME,
                  USD_WARMUP + USD_FRAMES]
        ckpt = os.path.join(tmp, "state.npz")
        for half in range(2):
            with tr.scope("window"):
                for k in range(window[half], window[half + 1]):
                    state = usd_frame(pipe, solver, state, ctls[k])
            if half == 0:
                with tr.scope("save"):
                    save_state(ckpt, state)
        launches = gen_launches()
        n_sub = USD_FRAMES * SUBSTEPS
        if launches != (n_sub, n_sub, 0):
            raise AssertionError(f"USD ant: launches {launches} in {n_sub} "
                                 "substeps")
        win_s = next(c for c in tr.root["children"]
                     if c["name"] == "window")["elapsed"]
        res.update(frames=USD_FRAMES, substeps=n_sub, launches=launches,
                   env_steps_per_s=n_sub * USD_W / win_s,
                   frame_ms=win_s * 1e3 / USD_FRAMES)
        valid = check_state_valid(state)
        if not valid["valid"]:
            raise AssertionError(f"USD ant: check_state_valid {valid}")
        nan_sweep(state, context="USD ant")
        res["gates"] = dict(check_state_valid=valid, nan_sweep="clean",
                            torso_z_min=float(state.body_q[:, 0, 2].min()),
                            torso_z_mean=float(state.body_q[:, 0, 2].mean()))
        # the checkpoint: frames 10-20 replayed from it, twice
        end = state_digest(state)
        digests = []
        for _ in range(2):
            with tr.scope("load"):
                s = load_state(ckpt, model.state())
            with tr.scope("replay"):
                for k in range(window[1], window[2]):
                    s = usd_frame(pipe, solver, s, ctls[k])
            digests.append(state_digest(s))
        if digests != [end, end]:
            raise AssertionError(f"USD ant: replay from the checkpoint "
                                 f"differs: {digests} vs {end}")
        res["checkpoint"] = dict(frame=USD_CKPT_FRAME, digest=end,
                                 replays_equal=2,
                                 bytes=os.path.getsize(ckpt))
    # a frame through the kernels against one through the plain versions
    ctl = ctls[-1]
    rec = {}
    ks = usd_frame(pipe, solver, state, ctl, record=rec)
    ps = usd_frame(pipe, solver, state, ctl, kernels=False)
    paths = {}
    for name, tol in USD_TOL.items():
        ok, e = close(getattr(ks, name), getattr(ps, name), tol, tol)
        if not ok:
            raise AssertionError(f"USD ant: {name} kernel vs plain frame off "
                                 f"tolerance ({e:.3g})")
        paths[name] = e
    # B1 and B2 against their plain versions on this path's operands (the
    # frame's last substep)
    Mi, rhs = rec["chol"]
    args, kw = rec["pgs"]
    res.update(paths=paths, b1=dict(
        d=Mi.shape[-1], max_abs_err=b1_check(Mi, rhs, "USD ant")[0],
        **b1_times(Mi, rhs)), b2=b2_record(args, kw, "USD ant"),
        active_contact_envs=int(args[4][:, :kw["c"]].any(1).sum()))
    # unbatch_env of 4 worlds against the CPU port stepping those worlds
    idx = [0, 1, USD_W // 2, USD_W - 1]
    cpu = b_bin.finalize("cpu")
    cpu_solver = nt.SolverMuJoCo(cpu, iterations=ITERS, integrator="euler")
    ctl4 = nt.Control(joint_target_q=ctl.joint_target_q[idx],
                      joint_target_qd=ctl.joint_target_qd[idx],
                      joint_f=ctl.joint_f[idx], custom={})
    res["vs_cpu"] = vs_cpu(
        lambda s, c, k: solver.step_batched(s, None, c, k, DT),
        lambda s, c, k: cpu_solver.step_batched(s, None, c, k, DT),
        stack_worlds([unbatch_env(state, i) for i in idx]), ctl4, pipe,
        nt.CollisionPipeline(cpu), "USD ant", USD_PARITY_W,
        substeps=SUBSTEPS)
    # two runs of a frame bit for bit; host syncs of a frame
    a, b = (usd_frame(pipe, solver, state, ctl) for _ in range(2))
    if state_digest(a) != state_digest(b):
        raise AssertionError("USD ant: two runs of a frame differ")
    _, syncs = count_syncs(lambda: usd_frame(pipe, solver, state, ctl))
    res.update(host_syncs_per_frame=syncs, sync_sites=list(SYNC_SITES))
    if syncs:
        raise AssertionError(f"USD ant: {syncs} host syncs a frame: "
                             f"{SYNC_SITES}")
    prof = profile_frame(lambda: usd_frame(pipe, solver, state, ctl),
                         SUBSTEPS)
    res.update(profile=prof, busy_share_unprofiled=busy_unprofiled(
        prof, USD_W, res["env_steps_per_s"]))
    if prof is not None:
        res["device_ms_per_frame"] = prof["device_busy_ms"]
        res["device_ops_per_frame"] = prof["device_ops"]
    res["stage_s"] = {c["name"]: c["elapsed"] for c in tr.root["children"]}
    return res, tr.report()


def usd_kernel_entries(usd, b1_src, b2_src):
    """The kernels line's entries of phase 59: B1 and B2 at the USD ant's
    shapes (the slice's main path)."""
    from newton_tpu_torch.solvers.generalized import linalg
    path = ("USD ant x 4096: ant.usda through a .usdc round trip and "
            "add_usd, step_batched (phase 59, the main path)")
    d = usd["b1"]["d"]
    inst = linalg.kernel_instance(d)
    b2 = usd["b2"]
    c, nl, d2 = b2["shape"]
    return [
        dict(name=f"chol_inv_solve [{inst}] d={d} W={USD_W}", **b1_src,
             instance=inst, path=path, launches=usd["launches"][0],
             max_abs_err=usd["b1"]["max_abs_err"], ms=usd["b1"]["ms"],
             plain_ms=usd["b1"]["plain_ms"],
             **bound_fields("chol_inv_solve", usd["b1"]["ms"], d=d, W=USD_W),
             library_ms=usd["b1"]["library_ms"]),
        dict(name=f"pgs_solve_fused [{b2['instance']}] {b2['shape']} "
                  f"W={USD_W}", **b2_src, instance=b2["instance"],
             path=path, launches=usd["launches"][1],
             max_abs_err=b2["lam_err"], ms=b2["ms"],
             plain_ms=b2["plain_ms"],
             **bound_fields("pgs_solve_fused", b2["ms"], c=c, nl=nl, d=d2,
                            W=USD_W, iters=ITERS))]


EX_W = 4096                           # the humanoid batch x 4096 (60)
EX_FRAMES = 20
EX_PARITY_W = 4                       # worlds held to the CPU port
EX_TOL = {"joint_q": 2e-4, "joint_qd": 5e-3}
# the frame counts of the JAX package's example sweep
# (tests/test_examples.py:FRAMES) for the ported examples; 8 where it
# names none
EXAMPLE_FRAMES = {
    "robot_cartpole": 50, "tendon_finger": 200, "robot_policy": 40,
    "robot_arm_reach": 120, "robot_walker2d": 30, "robot_cheetah": 30,
    "controller_impedance_hetero": 120, "mpm_granular": 60,
    "mpm_snow_ball": 25, "mpm_viscous": 25, "mpm_multi_material": 25,
    "mpm_beam_twist": 30}
# examples that phase 60 runs 8 frames without their test_final, to keep
# the phase inside its 90 s: eager substeps of a one-world model are
# host-bound on the card at 25-60 ms (at their sweep frame counts these
# eight took 99 s of the phase's 152 s in one call); the slow CPU tier of
# tests/test_torch_examples.py runs their test_final
EXAMPLE_CUT = ("controller_impedance_hetero", "mpm_granular",
               "robot_arm_reach", "robot_cartpole", "robot_cheetah",
               "robot_policy", "robot_walker2d", "tendon_finger")
# the kernels each example must launch: B2 only where it collides
EXAMPLE_KERNELS = {
    **{n: ("chol_inv_solve", "pgs_solve_fused") for n in (
        "robot_humanoid_batch", "robot_ant", "robot_cheetah",
        "robot_walker2d", "robot_policy", "terrain_ant")},
    **{n: ("chol_inv_solve",) for n in (
        "robot_cartpole", "robot_arm_reach", "tendon_finger",
        "controller_impedance_hetero")},
    **{n: ("p2g_apply", "g2p_apply") for n in (
        "mpm_sand", "mpm_granular", "mpm_multi_material", "mpm_snow_ball",
        "mpm_viscous", "mpm_beam_twist")}}


def example_of(name, argv=()):
    """An example built as ``python -m newton_tpu_torch.examples`` builds
    it: the registry's module, ``init``'s viewer and args."""
    import importlib
    from newton_tpu_torch.examples import EXAMPLES, init
    viewer, args = init([name, *argv])
    return importlib.import_module(EXAMPLES[name]).Example(viewer, args)


def example_launches():
    b1, b2 = kernel_launches()
    return dict(chol_inv_solve=b1, pgs_solve_fused=b2,
                **{k: v for k, v in mpm_launches().items()})


def example_frame_paths(ex, label):
    """One frame of a robot example through the kernels and one through
    the plain versions from one cloned state: joint_q 2e-4 and joint_qd
    5e-3 (atol = rtol); a world whose B2 guard halvings differ between
    the kernel and its plain version on some substep's operands takes
    another discrete path and is counted and left out (at most 1 in
    1000). Returns (errors, the last substep's record)."""
    import torch
    n = ex.worlds
    start = ex.state.clone()
    s = start.clone()
    left_out = torch.zeros(n, dtype=torch.bool, device=start.joint_q.device)
    for _ in range(ex.substeps):
        rec = {}
        s = ex.solver.step(s, None, ex.control, ex.pipeline.collide(s),
                           ex.sim_dt, record=rec)
        left_out |= ~compare_pgs(*rec["pgs"], n // 1000)[4]
    if int(left_out.sum()) > n // 1000:
        raise AssertionError(f"{label}: {int(left_out.sum())} worlds with "
                             "different guard halvings")
    ex.state, ex.kernels = start.clone(), False
    ex.step()
    p, ex.state, ex.kernels = ex.state, start, True
    errs = dict(guard_mismatch_worlds=int(left_out.sum()))
    for name, tol in EX_TOL.items():
        a = getattr(s, name).view(n, -1)[~left_out]
        b = getattr(p, name).view(n, -1)[~left_out]
        ok, e = close(a, b, tol, tol)
        if not ok:
            raise AssertionError(f"{label}: {name} kernel vs plain frame "
                                 f"off tolerance ({e:.3g})")
        errs[name] = e
    return errs, rec


def phase_examples_main(dev):
    """Phase 60 (a): the humanoid batch x 4096 through the examples'
    registry (see the module docstring)."""
    import dataclasses
    import torch
    label = f"humanoid batch x {EX_W}"
    res = dict(worlds=EX_W)
    t0 = time.perf_counter()
    ex = example_of("robot_humanoid_batch",
                    ["--num-worlds", str(EX_W), "--viewer", "null"])
    if ex.model.device.type != dev.type:
        raise AssertionError(f"{label}: built on {ex.model.device}")
    res["setup_s"] = time.perf_counter() - t0
    ex.step()
    ex.render()
    torch.cuda.synchronize()
    reset_robot_launches()
    t0 = time.perf_counter()
    for _ in range(EX_FRAMES):
        ex.step()
        ex.render()
    torch.cuda.synchronize()
    win = time.perf_counter() - t0
    launches = kernel_launches()
    n_sub = EX_FRAMES * ex.substeps
    if launches != (n_sub, n_sub):
        raise AssertionError(f"{label}: launches {launches} in {n_sub} "
                             "substeps")
    res.update(frames=EX_FRAMES, substeps=n_sub, launches=launches,
               env_steps_per_s=n_sub * EX_W / win,
               frame_ms=win * 1e3 / EX_FRAMES)
    st = ex.state
    if not all(bool(torch.isfinite(getattr(st, k)).all()) for k in
               ("joint_q", "joint_qd", "body_q", "body_qd")):
        raise AssertionError(f"{label}: non-finite state")
    q = st.joint_q.view(EX_W, -1)
    quat_err = max(float((torch.linalg.vector_norm(x, dim=-1) - 1.0)
                         .abs().max()) for x in (q[:, 3:7],
                                                 st.body_q[:, 3:7]))
    if quat_err > 1e-4:
        raise AssertionError(f"{label}: quaternion norms off 1 by "
                             f"{quat_err:.3g}")
    ex.test_final()
    res["gates"] = dict(finite=True, quat_norm_err=quat_err,
                        test_final="passed",
                        root_z_min=float(q[:, 2].min()),
                        root_z_mean=float(q[:, 2].mean()))
    res["paths"], rec = example_frame_paths(ex, label)
    Mi, rhs = rec["chol"]
    args, kw = rec["pgs"]
    res.update(b1=dict(d=Mi.shape[-1], max_abs_err=b1_check(
        Mi, rhs, label)[0], **b1_times(Mi, rhs)),
        b2=b2_record(args, kw, label),
        active_contact_envs=int(args[4][:, :kw["c"]].any(1).sum()))
    # 4 worlds of the example on the card against the CPU port, from the
    # card's state after the window
    ex_d = example_of("robot_humanoid_batch",
                      ["--num-worlds", str(EX_PARITY_W), "--viewer", "null"])
    ex_c = example_of("robot_humanoid_batch",
                      ["--num-worlds", str(EX_PARITY_W), "--viewer", "null",
                       "--device", "cpu"])
    nq = ex.model.structure.joint_coord_count // EX_W
    nd = ex.model.structure.joint_dof_count // EX_W
    nb = ex.model.structure.body_count // EX_W
    k = EX_PARITY_W
    s4 = dataclasses.replace(
        ex_d.state, joint_q=st.joint_q[:k * nq].clone(),
        joint_qd=st.joint_qd[:k * nd].clone(),
        body_q=st.body_q[:k * nb].clone(),
        body_qd=st.body_qd[:k * nb].clone())
    res["vs_cpu"] = vs_cpu(
        lambda s, c, kk: ex_d.solver.step(s, None, c, kk, ex_d.sim_dt),
        lambda s, c, kk: ex_c.solver.step(s, None, c, kk, ex_c.sim_dt),
        s4, ex_d.control, ex_d.pipeline, ex_c.pipeline, label, k,
        substeps=ex.substeps)

    def frame():
        ex.step()
        ex.render()
    _, syncs = count_syncs(frame)
    res.update(host_syncs_per_frame=syncs, sync_sites=list(SYNC_SITES))
    prof = profile_frame(frame, ex.substeps)
    res.update(profile=prof, busy_share_unprofiled=busy_unprofiled(
        prof, EX_W, res["env_steps_per_s"]))
    if prof is not None:
        res["device_ms_per_frame"] = prof["device_busy_ms"]
        res["device_ops_per_frame"] = prof["device_ops"]
    return res


def phase_examples_rest(dev):
    """Phase 60 (b) and (c): every other ported example through ``main``
    in this process, then ``python -m newton_tpu_torch.examples robot_ant
    ... --test`` as a subprocess. Returns (per example: seconds, frames,
    launches; the subprocess's result; the MPM sand's state for the B3/B4
    rows)."""
    import contextlib
    import io
    import torch
    from newton_tpu_torch.examples import EXAMPLES, main
    out = {}
    for name in sorted(EXAMPLES):
        if name == "robot_humanoid_batch":
            continue
        cut = name in EXAMPLE_CUT
        frames = 8 if cut else EXAMPLE_FRAMES.get(name, 8)
        argv = [name, "--viewer", "null", "--num-frames", str(frames)]
        if not cut:
            argv.append("--test")
        reset_robot_launches()
        reset_mpm_launches()
        buf = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = example_launches()
        said = buf.getvalue().strip().splitlines()
        if rc != 0 or (not cut and said[-1:] != ["test passed"]):
            raise AssertionError(f"example {name}: rc {rc}, said {said}")
        if not all(launches[k] > 0 for k in EXAMPLE_KERNELS[name]):
            raise AssertionError(f"example {name}: launches {launches}")
        out[name] = dict(s=secs, frames=frames, test_final=not cut,
                         launches={k: launches[k]
                                   for k in EXAMPLE_KERNELS[name]})
    # the mpm_sand example's state for B3/B4 at its shapes
    sand = example_of("mpm_sand", ["--viewer", "null"])
    reset_mpm_launches()
    sand.step()
    sand_launches = mpm_launches()
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    sub = subprocess.run(
        [sys.executable, "-m", "newton_tpu_torch.examples", "robot_ant",
         "--viewer", "null", "--num-frames", "4", "--test"], cwd=HERE,
        env=env, capture_output=True, text=True, timeout=300)
    cli = dict(rc=sub.returncode, s=time.perf_counter() - t0,
               last_line=(sub.stdout.strip().splitlines() or [""])[-1])
    if cli["rc"] != 0 or cli["last_line"] != "test passed":
        raise AssertionError(f"python -m newton_tpu_torch.examples "
                             f"robot_ant: {cli}; {sub.stderr[-2000:]}")
    return out, cli, (sand, sand_launches)


def phase_examples_b34(dev, sand):
    """B3 and B4 at the mpm_sand example's shapes (its stencil after one
    frame): against the float64 plain result, timed beside their plain
    versions (phase 7's rules)."""
    import numpy as np
    import torch
    from newton_tpu_torch.solvers import mpm_transfer as mt
    ex, launches = sand
    res = ex.solver.res
    _, base, w, _ = ex.solver.stencil(ex.state.particle_q)
    # phase 7's channels (13 scattered, 12 gathered), random values
    rng = np.random.RandomState(5)
    vals = torch.as_tensor(rng.randn(base.shape[0], 13), dtype=torch.float32,
                           device=dev)
    grid = torch.as_tensor(rng.randn(res, res, res, 12),
                           dtype=torch.float32, device=dev)
    w64 = w.double()
    bins = mt.bin_particles(base, res)
    out = dict(N=int(base.shape[0]), res=res, launches=launches,
               active_nodes=active_nodes(base, res))
    for name, got, ref, S in (
            ("p2g", mt.p2g_apply(base, w, vals, res),
             mt.p2g_apply_plain(base, w64, vals.double(), res),
             mt.p2g_apply_plain(base, w64, vals.double().abs(), res)),
            ("g2p", mt.g2p_apply(base, w, grid, bins=bins),
             mt.g2p_apply_plain(base, w64, grid.double()),
             mt.g2p_apply_plain(base, w64, grid.double().abs()))):
        ok, e = transfer_err(got, ref, S)
        if not ok:
            raise AssertionError(f"mpm_sand example: {name} vs the float64 "
                                 f"plain result off tolerance ({e:.3g})")
        out[f"{name}_max_abs_err"] = e
    out["p2g_ms"] = time_ms(lambda: mt.p2g_apply(base, w, vals, res),
                            queued=True)
    out["p2g_plain_ms"] = time_ms(lambda: mt.p2g_apply_plain(base, w, vals,
                                                             res))
    out["g2p_ms"] = time_ms(lambda: mt.g2p_apply(base, w, grid, bins=bins),
                            queued=True)
    out["g2p_plain_ms"] = time_ms(lambda: mt.g2p_apply_plain(base, w,
                                                             grid))
    out["C"] = (int(vals.shape[-1]), int(grid.shape[-1]))
    return out


def phase_examples(dev):
    """Phase 60 whole ((a), (b), (c) and B3/B4 at the mpm_sand example's
    shapes), as tools/chip_phases.py runs it alone."""
    exm = phase_examples_main(dev)
    rest, cli, sand = phase_examples_rest(dev)
    return dict(main=exm, rest=rest, cli=cli,
                b34=phase_examples_b34(dev, sand))


def examples_kernel_entries(exm, b34, b1_src, b2_src):
    """The kernels line's entries of phase 60: B1 and B2 at the humanoid
    batch's shapes (the slice's main path), B3 and B4 at the mpm_sand
    example's."""
    from newton_tpu_torch.solvers.generalized import linalg
    path = ("humanoid batch x 4096 through python -m "
            "newton_tpu_torch.examples' registry (phase 60 (a), the main "
            "path)")
    mpm_path = "the mpm_sand example, one frame (phase 60 (b))"
    d = exm["b1"]["d"]
    inst = linalg.kernel_instance(d)
    b2 = exm["b2"]
    c, nl, d2 = b2["shape"]
    no_library = "no single PyTorch call computes this function: {}"
    mpm_src = dict(route="cuda",
                   source="newton_tpu_torch/csrc/mpm_transfer.cu")
    c3, c4 = b34["C"]
    return [
        dict(name=f"chol_inv_solve [{inst}] d={d} W={EX_W}", **b1_src,
             instance=inst, path=path, launches=exm["launches"][0],
             max_abs_err=exm["b1"]["max_abs_err"], ms=exm["b1"]["ms"],
             plain_ms=exm["b1"]["plain_ms"],
             **bound_fields("chol_inv_solve", exm["b1"]["ms"], d=d, W=EX_W),
             library_ms=exm["b1"]["library_ms"]),
        dict(name=f"pgs_solve_fused [{b2['instance']}] {b2['shape']} "
                  f"W={EX_W}", **b2_src, instance=b2["instance"],
             path=path, launches=exm["launches"][1],
             max_abs_err=b2["lam_err"], ms=b2["ms"],
             plain_ms=b2["plain_ms"],
             **bound_fields("pgs_solve_fused", b2["ms"], c=c, nl=nl, d=d2,
                            W=EX_W, iters=ITERS)),
        dict(name=f"mpm_p2g N={b34['N']} res={b34['res']}", **mpm_src,
             replaces="newton_tpu/solvers/mpm_pallas.py:82", path=mpm_path,
             launches=b34["launches"]["p2g_apply"],
             max_abs_err=b34["p2g_max_abs_err"], ms=b34["p2g_ms"],
             plain_ms=b34["p2g_plain_ms"],
             **bound_fields("mpm_p2g", b34["p2g_ms"], N=b34["N"], C=c3,
                            res=b34["res"]),
             library_ms=None, library=no_library.format(
                 "the 27-node B-spline weights times the values, "
                 "scattered"), timed="with its binning"),
        dict(name=f"mpm_g2p N={b34['N']} res={b34['res']}", **mpm_src,
             replaces="newton_tpu/solvers/mpm_pallas.py:126", path=mpm_path,
             launches=b34["launches"]["g2p_apply"],
             max_abs_err=b34["g2p_max_abs_err"], ms=b34["g2p_ms"],
             plain_ms=b34["g2p_plain_ms"],
             **bound_fields("mpm_g2p", b34["g2p_ms"], N=b34["N"], C=c4,
                            active_nodes=b34["active_nodes"]),
             library_ms=None, library=no_library.format(
                 "the 27-node B-spline weighted gather"),
             timed="given the frame's bins")]


def bound_fields(name, ms, prefix="", **shape):
    """bound_ms, bound_by and share_of_bound of one timed call at W envs."""
    t, by = bound_ms(*kernel_cost(name, **shape))
    return {f"{prefix}bound_ms": t, f"{prefix}bound_by": by,
            f"{prefix}share_of_bound": t / ms}


def function_timers(path):
    """Wrap every function of this script (and its classes' methods) in a
    wall-clock timer, inclusive of what it calls, keyed by the phase_*
    function that is running; the table goes to ``path`` as JSON at exit,
    sorted by seconds."""
    import atexit
    import collections
    import inspect
    table = collections.defaultdict(lambda: [0.0, 0])
    phase = ["main"]

    def wrap(name, f):
        @functools.wraps(f)
        def timed(*args, **kw):
            outer = phase[0]
            if name.startswith("phase_"):
                phase[0] = name
            t0 = time.perf_counter()
            try:
                return f(*args, **kw)
            finally:
                cell = table[f"{phase[0]} :: {name}"]
                cell[0] += time.perf_counter() - t0
                cell[1] += 1
                phase[0] = outer
        return timed
    mod = sys.modules[__name__]
    for name, f in list(vars(mod).items()):
        if (inspect.isfunction(f) and f.__module__ == __name__
                and name not in ("main", "function_timers")):
            setattr(mod, name, wrap(name, f))
    for cls in (PolicyAnt, CameraAnt):
        for name, f in list(vars(cls).items()):
            if inspect.isfunction(f):
                setattr(cls, name, wrap(f"{cls.__name__}.{name}", f))

    def dump():
        rows = sorted(([k, v[0], v[1]] for k, v in table.items()),
                      key=lambda r: -r[1])
        with open(path, "w") as f:
            json.dump({"seconds_calls": rows}, f, indent=0)
    atexit.register(dump)


def main():
    import torch
    if "--function-times" in sys.argv:
        function_timers(sys.argv[sys.argv.index("--function-times") + 1])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import newton_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: newton_tpu_torch not found beside this script",
              file=sys.stderr)
        return 2
    from newton_tpu_torch import _kernels
    from newton_tpu_torch.solvers.generalized import linalg, pgs
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    results = {}
    marks = [time.perf_counter()]

    def mark(label):
        """Seconds since the previous mark, under results["phase_s"]."""
        marks.append(time.perf_counter())
        results.setdefault("phase_s", {})[label] = marks[-1] - marks[-2]

    card = card_line()
    print(f"[1 device] {torch.cuda.get_device_name(0)}; nvidia-smi: {card}",
          flush=True)
    mark("1")

    t0 = time.perf_counter()
    _kernels.lib()
    print(f"[2 build] {time.perf_counter() - t0:.1f} s "
          f"(nvcc sm_90a, ctypes)", flush=True)
    mark("2")
    with open(os.path.join(os.path.dirname(_kernels.build()),
                           "ptxas.log")) as f:
        results["ptxas"] = [ln for ln in f.read().splitlines()
                            if "registers" in ln or "spill" in ln]

    b1 = phase_b1(dev)
    results["b1"] = b1
    print(f"[3 B1 chol_inv_solve] kernel == plain, d=14,23 W={W}, max abs "
          f"err {b1['max_abs_err']:.3g}, normwise vs float64 "
          f"{b1['normwise']}; " + "; ".join(
              f"d={d} {t['ms']:.4f} ms vs plain {t['plain_ms']:.4f} ms, "
              f"torch.linalg.solve {t['library_ms']:.4f} ms"
              for d, t in b1["times"].items()), flush=True)
    mark("3")

    model, pipe, solver, state0 = build_ant(dev)
    b2, dropped, _ = phase_b2(dev, model, pipe, solver, state0)
    results["b2"] = b2
    mism = {k: v["guard_mismatch_envs"] for k, v in b2["cases"].items()}
    print(f"[4 B2 pgs_solve_fused] kernel == plain, ant shapes W={W}, lam "
          f"err {b2['max_abs_err']:.3g}, dqd err {b2['dqd_max_abs_err']:.3g}"
          f"; guard-mismatch envs {mism}; {b2['ms']:.4f} ms vs plain "
          f"{b2['plain_ms']:.4f} ms", flush=True)
    mark("4")

    main_res, final = phase_main(dev, model, pipe, solver, state0)
    results["main"] = main_res
    print(f"[5 main path] ant x {W} envs, {main_res['substeps']} substeps, "
          f"launches {main_res['launches']}, root z min "
          f"{main_res['root_z_min']:.3f}; {main_res['env_steps_per_s']:.1f} "
          f"env-steps/s (plain path {main_res['plain_env_steps_per_s']:.1f})"
          f" on {card}", flush=True)
    mark("5")

    paths = phase_paths(model, pipe, solver,
                        {"main-path end": final, "drop 0.08": dropped},
                        ctrl_sampler(model, dev, seed=3))
    results["paths"] = paths
    print(f"[6 kernel vs plain substep] {paths}", flush=True)
    mark("6")

    _, sand_solver, sand0 = build_sand(dev)
    b34 = phase_b34(dev, sand_solver, sand0)
    results["b34"] = b34
    print(f"[7 B3/B4 mpm p2g/g2p] kernels and plain f32 within 1e-5 S + "
          f"1e-7 of float64, N={MPM_N} res={MPM_RES}, cases "
          f"{b34['cases']}; p2g max abs err {b34['p2g_max_abs_err']:.3g}, "
          f"{b34['p2g_ms']:.4f} ms with its binning, "
          f"{b34['p2g_given_bins_ms']:.4f} ms given bins, binning "
          f"{b34['bin_ms']:.4f} ms, plain {b34['p2g_plain_ms']:.4f} ms; g2p "
          f"max abs err {b34['g2p_max_abs_err']:.3g}, {b34['g2p_ms']:.4f} ms "
          f"given bins ({b34['g2p_with_binning_ms']:.4f} ms with its "
          f"binning), plain {b34['g2p_plain_ms']:.4f} ms; sand stencils "
          f"touch {b34['active_nodes']} nodes", flush=True)
    mark("7")

    mpm, sand_end = phase_mpm_main(sand_solver, sand0)
    results["mpm"] = mpm
    print(f"[8 MPM main path] sand x {MPM_N} particles, res {MPM_RES}, "
          f"{mpm['steps']} steps, launches {mpm['launches']}, gates "
          f"{mpm['gates']}; {mpm['particle_steps_per_s']:.1f} "
          f"particle-steps/s (plain path "
          f"{mpm['plain_particle_steps_per_s']:.1f}) on {card}", flush=True)
    mark("8")

    side = phase_mpm_side(dev)
    results["mpm_side"] = side
    print(f"[9 MPM CG and rheology paths] " + "; ".join(
        f"{k}: launches {v['launches']} in {MPM_SIDE_STEPS} steps "
        f"({v['per_step']} per step), {v['particle_steps_per_s']:.1f} "
        f"particle-steps/s" for k, v in side.items()), flush=True)
    mark("9")

    mpm_paths = phase_mpm_paths(sand_solver, sand_end)
    results["mpm_paths"] = mpm_paths
    print(f"[10 kernel vs plain MPM step] max |C| "
          f"{mpm_paths['c_max']:.3g}; " + "; ".join(
              f"{k}: " + ", ".join(f"{a} {b:.3g}" for a, b in v.items())
              for k, v in mpm_paths["errors"].items()), flush=True)
    mark("10")

    hmodel, hpipe, hsolver = build_humanoid(dev)
    hum, hum_end = phase_humanoid_main(dev, hmodel, hpipe, hsolver)
    results["humanoid"] = hum
    print(f"[11 humanoid main path] humanoid x {HUMANOID_W} envs, "
          f"{hum['substeps']} substeps, launches {hum['launches']}, root z "
          f"min {hum['root_z_min']:.3f}, envs in contact during the window"
          f" {HUMANOID_W - hum['envs_untouched_in_window']}, at its end "
          f"{hum['envs_in_contact_at_end']}, active "
          f"contacts per env at the end mean "
          f"{hum['active_contacts_mean']:.2f} max "
          f"{hum['active_contacts_max']}; {hum['env_steps_per_s']:.1f} "
          f"env-steps/s (plain path {hum['plain_env_steps_per_s']:.1f}) on "
          f"{card}", flush=True)
    mark("11")

    hpaths = phase_humanoid_paths(dev, hmodel, hpipe, hsolver, hum_end)
    results["humanoid_paths"] = hpaths
    ht = hpaths["times"]
    print(f"[12 humanoid kernel vs plain substeps] {hpaths['cases']}; B1 "
          f"d=23 {ht['b1_ms']:.4f} ms vs plain {ht['b1_plain_ms']:.4f} ms, "
          f"torch.linalg.solve {ht['b1_library_ms']:.4f} ms; "
          f"B2 (32, 17, 23) {ht['b2_ms']:.4f} ms vs plain "
          f"{ht['b2_plain_ms']:.4f} ms; B2 (192, 17, 23) "
          f"{ht['b2_uncompacted_ms']:.4f} ms vs plain "
          f"{ht['b2_uncompacted_plain_ms']:.4f} ms; shared memory "
          f"{hpaths['smem_bytes']} B", flush=True)
    mark("12")

    cart = phase_cartpole(dev)
    results["cartpole"] = cart
    print(f"[13 cartpole x {WORLDS}, replicate + step] setup "
          f"{cart['setup_s']:.2f} s, {cart['substeps']} substeps, launches "
          f"{cart['launches']}, slider |x| max {cart['slider_max']:.4f}; "
          f"{cart['env_steps_per_s']:.1f} env-steps/s (plain path "
          f"{cart['plain_env_steps_per_s']:.1f}); kernel vs plain step "
          f"{cart['paths']}; B1 d=2 {cart['b1']['ms']:.4f} ms vs plain "
          f"{cart['b1']['plain_ms']:.4f} ms, torch.linalg.solve "
          f"{cart['b1']['library_ms']:.4f} ms on {card}", flush=True)
    mark("13")

    hw = phase_humanoid_worlds(dev)
    results["humanoid_worlds"] = hw
    print(f"[14 humanoid x {WORLDS}, replicate + step] setup "
          f"{hw['setup_s']:.2f} s, {hw['substeps']} substeps, launches "
          f"{hw['launches']}, root z min {hw['root_z_min']:.3f}, worlds "
          f"without contact in the window {hw['worlds_untouched_in_window']}"
          f"; {hw['env_steps_per_s']:.1f} env-steps/s (plain path "
          f"{hw['plain_env_steps_per_s']:.1f}); peak memory "
          f"{hw['peak_memory_bytes']} B; step vs step_batched max diff "
          f"{hw['step_vs_batched']}; kernel vs plain step {hw['paths']}; "
          f"B1 d=23 {hw['times']['b1']['ms']:.4f} ms (library "
          f"{hw['times']['b1']['library_ms']:.4f} ms), B2 (32, 17, 23) "
          f"{hw['times']['b2_ms']:.4f} ms on {card}", flush=True)
    mark("14")

    chains = phase_chains(dev)
    results["chains"] = chains
    print("[15 C.1 shapes] " + "; ".join(
        f"chain {k}: {v['envs']} envs, B1 d={v['d']} {v['b1_instance']} "
        f"{v['b1']['ms']:.4f} ms (bit-exact {v['b1_bit_exact']}), B2 "
        f"{v['b2_shape']} {v['b2_instance']} {v['b2_ms']:.4f} ms, launches "
        f"{v['launches']}, kernel vs plain step {v['paths']}"
        for k, v in chains.items() if isinstance(k, int))
        + "; B2 random (192, 40, 48) "
        + json.dumps(chains["random (192, 40, 48)"]), flush=True)
    mark("15")

    cheetah = phase_cheetah(dev)
    results["half_cheetah"] = cheetah
    print(f"[16 half_cheetah x {PLANAR_W}, step_batched] {cheetah['substeps']}"
          f" substeps, launches {cheetah['launches']}, torso z min "
          f"{cheetah['torso_z_min']:.3f}, envs without contact in the window "
          f"{cheetah['envs_untouched_in_window']}; "
          f"{cheetah['env_steps_per_s']:.1f} env-steps/s (plain path "
          f"{cheetah['plain_env_steps_per_s']:.1f}); kernel vs plain substep "
          f"{cheetah['paths']}; {SHIFT_X:g} m along x after 4 substeps "
          f"{cheetah['shift']}; B1 d=9 {cheetah['b1']['ms']:.4f} ms (library "
          f"{cheetah['b1']['library_ms']:.4f} ms), B2 (16, 6, 9) "
          f"{cheetah['b2_ms']:.4f} ms on {card}", flush=True)
    mark("16")

    hop = phase_hopper_worlds(dev)
    results["hopper_worlds"] = hop
    print(f"[17 hopper x {WORLDS}, replicate + step, RK4] setup "
          f"{hop['setup_s']:.2f} s, {hop['substeps']} substeps, launches "
          f"{hop['launches']}, torso z min {hop['torso_z_min']:.3f}; "
          f"{hop['env_steps_per_s']:.1f} env-steps/s (plain path "
          f"{hop['plain_env_steps_per_s']:.1f}); peak memory "
          f"{hop['peak_memory_bytes']} B; step vs step_batched max diff "
          f"{hop['step_vs_batched']}; kernel vs plain step {hop['paths']}; "
          f"B1 d=6 {hop['b1']['ms']:.4f} ms (library "
          f"{hop['b1']['library_ms']:.4f} ms), B2 (14, 3, 6) "
          f"{hop['b2_ms']:.4f} ms on {card}", flush=True)
    mark("17")

    rod = phase_rod(dev)
    results["rod"] = rod
    print(f"[18 rod x {HETERO_W}, ball joints, replicate with spacing + step]"
          f" setup {rod['setup_s']:.2f} s, {rod['substeps']} substeps, "
          f"launches {rod['launches']}, tip z {rod['tip_z']}, tips vs world "
          f"0 moved by the spacing {rod['tip_shift_err']:.3g}; "
          f"{rod['env_steps_per_s']:.1f} env-steps/s (plain path "
          f"{rod['plain_env_steps_per_s']:.1f}); peak memory "
          f"{rod['peak_memory_bytes']} B; step vs its group alone "
          f"{rod['groups_alone']}; kernel vs plain step {rod['paths']}; B1 "
          f"d=21 {rod['b1']['ms']:.4f} ms (library "
          f"{rod['b1']['library_ms']:.4f} ms) on {card}", flush=True)
    mark("18")

    ab = phase_ant_ball(dev)
    results["ant_ball"] = ab
    print(f"[19 ant with a ball x {HETERO_W}, randomized, step] setup "
          f"{ab['setup_s']:.2f} s, {ab['substeps']} substeps, launches "
          f"{ab['launches']}, root z min {ab['root_z_min']:.3f}, worlds "
          f"touching the ball in the window {ab['worlds_touching_ball']}, "
          f"ball speed max {ab['ball_speed_max']:.3f} m/s, two-sided halves "
          f"{ab['halves']}; {ab['env_steps_per_s']:.1f} env-steps/s (plain "
          f"path {ab['plain_env_steps_per_s']:.1f}); peak memory "
          f"{ab['peak_memory_bytes']} B; step vs its groups alone "
          f"{ab['groups_alone']}; kernel vs plain step {ab['paths']}; "
          + "; ".join(f"group {gi}: B1 d={t['d']} {t['b1']['ms']:.4f} ms "
                      f"(library {t['b1']['library_ms']:.4f} ms), B2 "
                      f"{t['b2_shape']} {t['b2_instance']} with w_other "
                      f"{t['b2_ms']:.4f} ms" for gi, t in ab["times"].items())
          + f" on {card}", flush=True)
    mark("19")

    sr = phase_showcase_ragged(dev)
    results["showcase_ragged"] = sr
    sc, rg = sr["showcase"], sr["ragged"]
    print(f"[20 joint showcase and ragged plan x {SHOWCASE_W}] showcase: "
          f"launches {sc['launches']} in {sc['substeps']} substeps, gates "
          f"{sc['gates']}, vs groups alone {sc['groups_alone']}; ragged: "
          f"launches {rg['launches']} in {rg['substeps']} substeps, z err "
          f"{rg['z_err']:.4f}, {rg['pad_entries']} pad entries, B2 "
          f"{rg['b2_shape']} {rg['b2_instance']} {rg['b2_ms']:.4f} ms, "
          f"kernel vs plain step {rg['paths']}", flush=True)
    mark("20")

    ax = phase_ant_xpbd(dev)
    results["ant_xpbd"] = ax
    print(f"[21 ant x {XPBD_W} under XPBD, bench.py --solver xpbd] setup "
          f"{ax['setup_s']:.2f} s, {ax['substeps']} timed substeps, root z "
          f"min {ax['root_z_min']:.3f} ({ax['worlds_root_z_below_0_1']} "
          f"worlds below 0.1); {ax['env_steps_per_s']:.1f} "
          f"env-steps/s; peak memory {ax['peak_memory_bytes']} B; "
          f"{XPBD_CPU_WORLDS} worlds card vs CPU after {SUBSTEPS} substeps "
          f"{ax['vs_cpu']}; two runs of a substep differ by "
          f"{ax['repeat_max_diff']}; device busy "
          f"{ax['busy_share_unprofiled']} of an unprofiled substep; "
          f"profiled substep {ax['profile']} on {card}", flush=True)
    mark("21")

    pyr = phase_pyramid(dev)
    results["pyramid"] = pyr
    print(f"[22 pyramid x {BOX_W}, SolverFeatherstone on box rows] setup "
          f"{pyr['setup_s']:.2f} s, {pyr['substeps']} substeps, launches "
          f"{pyr['launches']}, gates {pyr['gates']}; "
          f"{pyr['env_steps_per_s']:.1f} env-steps/s (plain path "
          f"{pyr['plain_env_steps_per_s']:.1f}); kernel vs plain step "
          f"{pyr['paths']}; B1 d=36 {pyr['b1_instance']} "
          f"{pyr['b1']['ms']:.4f} ms (library {pyr['b1']['library_ms']:.4f}"
          f" ms), B2 (32, 0, 36) {pyr['b2_instance']} {pyr['b2_ms']:.4f} ms"
          f"; contact_cap=0: B2 (288, 0, 36) global256 "
          f"{pyr['uncompacted']} on {card}", flush=True)
    mark("22")

    dom = phase_domino(dev)
    results["domino"] = dom
    print(f"[23 domino spiral x {BOX_W} under XPBD] setup "
          f"{dom['setup_s']:.2f} s, {dom['substeps']} substeps, first five "
          f"tipped in {dom['worlds_first_five_tipped']} worlds, all ten in "
          f"{dom['worlds_all_tipped']}; {dom['env_steps_per_s']:.1f} "
          f"env-steps/s; device busy {dom['busy_share_unprofiled']} of an "
          f"unprofiled frame; profiled frame {dom['profile']} on {card}",
          flush=True)
    mark("23")

    sty = phase_cloth_style3d(dev)
    results["cloth_style3d"] = sty
    print(f"[24 cloth {CLOTH_DIM}x{CLOTH_DIM} under Style3D, bench.py --mode "
          f"cloth] {sty['vertices']} vertices, setup {sty['setup_s']:.2f} s, "
          f"{sty['substeps']} timed substeps, gates {sty['gates']}, PCG "
          f"residual {sty['pcg_relative_residual']:.3g}; "
          f"{sty['vertex_steps_per_s']:.1f} vertex-steps/s; peak memory "
          f"{sty['peak_memory_bytes']} B; card vs CPU substep "
          f"{sty['vs_cpu']}; two runs of a substep differ by "
          f"{sty['repeat_max_diff']}; device busy "
          f"{sty['busy_share_unprofiled']} of an unprofiled frame; profiled "
          f"frame {sty['profile']} on {card}", flush=True)
    mark("24")

    gar = phase_garment(dev)
    results["garment"] = gar
    print(f"[25 Style3D garment, example_cloth_style3d.py] {gar['vertices']} "
          f"vertices, {gar['soft_pairs']} soft pairs "
          f"({gar['active_soft_contacts_at_end']} active at the end), "
          f"{gar['substeps']} substeps in {gar['seconds']:.2f} s, seam gap "
          f"{gar['seam_gap']:.4f}, max z {gar['z_max']:.4f} at frame "
          f"{GARMENT_FRAMES} ({gar['z_max_min_to_hold_frame']:.4f} at its "
          f"lowest through frame {GARMENT_HOLD_FRAMES}; every 5th frame "
          f"{gar['z_max_frames_5']}); card vs CPU "
          f"substep {gar['vs_cpu']}, repeat {gar['repeat_max_diff']} on "
          f"{card}", flush=True)
    mark("25")

    vbd = phase_vbd(dev)
    results["vbd"] = vbd
    vb, vg = vbd["bending"], vbd["grid"]
    print(f"[26 VBD] (a) example_cloth_bending.py: spans {vb['spans']}, min "
          f"z {vb['z_min']:.4f}, {vb['seconds']:.2f} s; (b) cloth "
          f"{CLOTH_DIM}x{CLOTH_DIM} under VBD(iterations=4): setup "
          f"{vg['setup_s']:.2f} s, gates {vg['gates']}; "
          f"{vg['vertex_steps_per_s']:.1f} vertex-steps/s; peak memory "
          f"{vg['peak_memory_bytes']} B; card vs CPU substep {vg['vs_cpu']}"
          f", repeat {vg['repeat_max_diff']}; device busy "
          f"{vg['busy_share_unprofiled']} of an unprofiled frame; profiled "
          f"frame {vg['profile']}; (c) soft contacts: "
          f"{vbd['soft_contacts']['active_soft_contacts']} active, repeat "
          f"{vbd['soft_contacts']['repeat_max_diff']}, card vs CPU "
          f"{vbd['soft_contacts']['vs_cpu']} on {card}", flush=True)
    mark("26")

    semi = phase_semi_implicit(dev)
    results["semi_implicit"] = semi
    print("[27 SemiImplicit] " + "; ".join(
        f"{k}: {v['vertices']} vertices, {v['tets']} tets, "
        f"{v['substeps']} substeps in {v['seconds']:.2f} s, pinned moved "
        f"{v['pinned_moved']}, sag {v['sag']:.4f}, card vs CPU substep "
        f"{v['vs_cpu']}, repeat {v['repeat_max_diff']}"
        for k, v in semi.items()) + f" on {card}", flush=True)
    mark("27")

    ik = phase_ik(dev)
    results["ik"] = ik
    print(f"[28 IK, bench.py --mode ik] {ik['problems']} problems x "
          f"{ik['seeds']} seeds x {ik['lm_iterations']} LM iterations: "
          f"{ik['solves_per_s']:.1f} solves/s, host syncs per solve "
          f"{ik['host_syncs_per_solve']}, peak memory "
          f"{ik['peak_memory_bytes']} B, tip error max "
          f"{ik['tip_error_max']:.3g} (median {ik['tip_error_median']:.3g}),"
          f" {ik['problems_missing_tip_gate']} problems off the 0.02 gate; "
          f"{IK_CPU_PROBLEMS} problems card vs CPU: residual "
          f"{ik['vs_cpu_residual']:.3g}, Jacobian "
          f"{ik['vs_cpu_jacobian_rel']:.3g} relative; q after one step "
          f"from seeds 1-3 {ik['vs_cpu_one_step_q_per_seed']}, from the "
          f"straight seed {ik['vs_cpu_one_step_q_straight_seed']:.3g} (tips "
          f"{ik['vs_cpu_one_step_tip_straight_seed']:.3g} m); after {IK_ITERS} "
          f"{ik['vs_cpu_problems_apart_1e_4']} apart by > 1e-4 (tip errors "
          f"{ik['vs_cpu_tip_error_max']}) on {card}", flush=True)
    mark("28")

    ws = phase_warm_sleep(dev)
    results["warm_sleep"] = ws
    print("[29 warm start and sleeping x 4096] B2 with random lam0 "
          f"{ws['random_lam0']}; " + "; ".join(
        f"{k}: launches {v['launches']} in {v['substeps']} substeps, B2 "
        f"{v['b2']['shape']} {v['b2']['instance']} warm vs plain lam "
        f"{v['b2']['lam_err']:.3g} ({v['b2']['guard_mismatch_rows']} rows "
        f"with other halvings), guard halvings warm "
        f"{v['b2']['halvings_warm']} cold {v['b2']['halvings_cold']}; "
        f"{v['env_steps_per_s_warm']:.1f} env-steps/s warm, "
        f"{v['env_steps_per_s_cold']:.1f} cold"
        for k, v in ws.items() if k != "random_lam0")
        + f"; ant root z {ws['ant']['root_z']}, "
        f"{ws['ant']['worlds_asleep']} ant worlds asleep; boxes "
        f"{ws['sleeping_boxes']['gates']}, "
        f"{ws['sleeping_boxes']['worlds_still_asleep']} worlds bit-frozen "
        f"over a frame on {card}", flush=True)
    mark("29")

    eq = phase_equality(dev)
    results["equality"] = eq
    print("[30 equality rows x 4096] " + "; ".join(
        f"{k}: launches {v['launches']} and {v['eq_launches']} of "
        f"chol_solve in {v['substeps']} substeps, gates "
        f"{v['gates']}, B1 solve r={v['rows']} {v['b1_eq_instance']} "
        f"{v['b1_eq_times']['ms']:.4f} ms (library "
        f"{v['b1_eq_times']['library_ms']:.4f} ms), {v['env_steps_per_s']:.1f}"
        f" env-steps/s" for k, v in eq.items()) + f" on {card}", flush=True)
    mark("30")

    urdf = phase_urdf(dev)
    results["urdf"] = urdf
    print("[31 URDF x 4096, add_urdf] " + "; ".join(
        f"{k}: setup {v['setup_s']:.2f} s, launches {v['launches']} in "
        f"{v['substeps']} substeps, gates {v['gates']}, "
        f"{v['env_steps_per_s']:.1f} env-steps/s" for k, v in urdf.items())
        + f" on {card}", flush=True)
    mark("31")

    nqp = phase_newton_qp(dev)
    results["newton_qp"] = nqp
    print("[32 Newton QP, penalty limits x 4096] " + "; ".join(
        f"ant {k}: launches {nqp['ant_' + k]['launches']} in "
        f"{nqp['ant_' + k]['substeps']} substeps, root z min "
        f"{nqp['ant_' + k]['root_z_min']:.3f}, host syncs per substep "
        f"{nqp['ant_' + k]['host_syncs_per_substep']} (Euler PGS "
        f"{nqp['ant_' + k]['host_syncs_euler_pgs']}), "
        f"{nqp['ant_' + k]['env_steps_per_s']:.1f} env-steps/s (plain "
        f"{nqp['ant_' + k]['plain_env_steps_per_s']:.1f}), peak "
        f"{nqp['ant_' + k]['peak_memory_bytes'] / 2 ** 20:.0f} MiB"
        for k in ("newton", "penalty"))
        + f"; masked solve {nqp['ant_newton']['masked_solve_shape']} "
        f"{nqp['ant_newton']['masked_solve_ms']:.4f} ms per call; resting "
        f"ball {nqp['ball']['gates']} on {card}", flush=True)
    mark("32")

    imp = phase_implicit(dev)
    results["implicit"] = imp
    print("[33 implicit integrators, humanoid x 4096] " + "; ".join(
        f"{k}: launches {v['launches']} in {v['substeps']} substeps, root z "
        f"min {v['root_z_min']:.3f}, host syncs {v['host_syncs_per_substep']}"
        f" (Euler {v['host_syncs_euler']}), B2 {v['b2']['shape']} "
        f"{v['b2']['instance']} symmetric={v['b2']['symmetric']} lam err "
        f"{v['b2']['lam_err']:.3g} ({v['b2']['guard_mismatch_rows']} rows "
        f"with other halvings) {v['b2']['ms']:.4f} ms, "
        f"{v['env_steps_per_s']:.1f} env-steps/s (plain "
        f"{v['plain_env_steps_per_s']:.1f})" for k, v in imp.items())
        + f"; LU {imp['implicit']['lu_shape']} "
        f"{imp['implicit']['lu_ms']:.4f} ms per call on {card}", flush=True)
    mark("33")

    ten = phase_tendons(dev)
    results["tendons"] = ten
    print("[34 spatial tendons, finger x 4096] " + "; ".join(
        f"{k}: launches {v['launches']} in {v['substeps']} substeps, gates "
        f"{v['gates']}, vs CPU {v['vs_cpu']}, {v['env_steps_per_s']:.1f} "
        f"env-steps/s (plain {v['plain_env_steps_per_s']:.1f})"
        for k, v in ten.items()) + f" on {card}", flush=True)
    mark("34")

    mus = phase_muscles(dev)
    results["muscles"] = mus
    print("[35 actuators and muscles x 4096] " + "; ".join(
        f"{k}: gates {v['gates']}, {v['env_steps_per_s']:.1f} env-steps/s"
        for k, v in mus.items()) + f" on {card}", flush=True)
    mark("35")

    kam = phase_kamino(dev)
    results["kamino"] = kam
    print(f"[36 SolverKamino] heavy stack x {STACK_W}: gates "
          f"{kam['heavy_stack']['gates']}, factor "
          f"{kam['heavy_stack']['factor_shape']} "
          f"{kam['heavy_stack']['factor_ms']:.4f} ms, host syncs "
          f"{kam['heavy_stack']['host_syncs_per_substep']}; four-bar x "
          f"{FOURBAR_W}: gates {kam['fourbar']['gates']}; islands x "
          f"{ISLAND_W}: vs dense {kam['islands']['island_vs_dense']}, factor "
          f"{kam['islands']['shape']} {kam['islands']['ms']:.4f} ms on "
          f"{card}", flush=True)
    mark("36")

    conv = phase_conveyor(dev)
    results["conveyor"] = conv
    print(f"[37 conveyor x {CONVEYOR_W}, kinematic belt, step_with_contacts] "
          f"launches {conv['launches']} in {conv['substeps']} substeps, gates "
          f"{conv['gates']}, B2 {conv['b2']['shape']} "
          f"{conv['b2']['instance']} with w_other (constant rows up to "
          f"{conv['b2_const_row_max']:.3f} m/s), vs CPU {conv['vs_cpu']}, "
          f"host syncs {conv['host_syncs_per_substep']}, "
          f"{conv['env_steps_per_s']:.1f} env-steps/s (plain "
          f"{conv['plain_env_steps_per_s']:.1f}) on {card}", flush=True)
    mark("37")

    mnt = phase_mounted(dev)
    results["mounted"] = mnt
    print(f"[38 mounted arm x {MOUNT_W}] groups {mnt['groups']}, launches "
          f"{mnt['launches']} in {mnt['substeps']} substeps, vs CPU "
          f"{mnt['vs_cpu']}, C.24 pinned {mnt['defect_c24']}, host syncs "
          f"{mnt['host_syncs_per_substep']}, {mnt['env_steps_per_s']:.1f} "
          f"env-steps/s (plain {mnt['plain_env_steps_per_s']:.1f}) on "
          f"{card}", flush=True)
    mark("38")

    tower = phase_tower(dev)
    results["tower"] = tower
    print(f"[39 third-law tower x {TOWER_W}] launches {tower['launches']}, "
          f"gates {tower['gates']}, B2 {tower['b2']['shape']} "
          f"{tower['b2']['instance']}, host syncs "
          f"{tower['host_syncs_per_substep']}, "
          f"{tower['env_steps_per_s']:.1f} env-steps/s on {card}", flush=True)
    mark("39")

    xcloth = phase_xpbd_cloth(dev, sty["vertex_steps_per_s"])
    results["xpbd_cloth"] = xcloth
    print(f"[40 bench cloth under SolverXPBD] {xcloth['vertices']} vertices, "
          f"gates {xcloth['gates']}, vs CPU {xcloth['vs_cpu']}, 20 x 20 x 4 "
          f"substeps vs CPU {xcloth['vs_cpu_20x20_4_substeps']}, host syncs "
          f"{xcloth['host_syncs_per_substep']}, "
          f"{xcloth['vertex_steps_per_s']:.1f} vertex-steps/s (Style3D "
          f"{xcloth['style3d_vertex_steps_per_s']:.1f} in this run) on "
          f"{card}", flush=True)
    mark("40")

    xpart = phase_xpbd_particles(dev)
    results["xpbd_particles"] = xpart
    print("[41-42 XPBD self-collision, granular pile] " + "; ".join(
        f"{k}: {v['particles']} particles, gates {v['gates']}, grid overflow "
        f"{v.get('grid_overflow_last_substep')}, vs CPU {v['vs_cpu']}, host "
        f"syncs {v['host_syncs_per_substep']}, "
        f"{v['particle_steps_per_s']:.1f} particle-steps/s"
        for k, v in xpart.items()) + f" on {card}", flush=True)
    mark("41-42")

    cab = phase_cables(dev)
    results["cables"] = cab
    print(f"[43-44 cables and Dahl friction x {CABLE_W}] pile: gates "
          f"{cab['pile']['gates']}, vs CPU {cab['pile']['vs_cpu']}, "
          f"{cab['pile']['env_steps_per_s']:.1f} env-steps/s; sag "
          f"{cab['sag']['gates']}; Dahl hysteresis {cab['dahl']['gates']}, vs "
          f"CPU {cab['dahl']['vs_cpu']}, {cab['dahl']['env_steps_per_s']:.1f} "
          f"env-steps/s; presliding hold: creep {cab['hold']['creep_max']:.4f} "
          f"m on {card}", flush=True)
    mark("43-44")

    shp = phase_shapes(dev)
    results["shapes"] = shp
    print("[45 cones and ellipsoids x 4096] " + "; ".join(
        f"{k}: gates {v['gates']}, vs CPU {v['vs_cpu']}, operations a "
        f"collide {v['ops']}, host syncs {v['host_syncs_per_substep']}, "
        f"{v['env_steps_per_s']:.1f} env-steps/s" for k, v in shp.items())
        + f" on {card}", flush=True)
    mark("45")

    pile, sap = phase_pile_sap(dev)
    results["box_pile"], results["sap"] = pile, sap
    print(f"[46 dynamic box pile x {PILE_W}] gates "
          f"{pile['gates']}, slots a world "
          f"{pile['slots_per_world']:.0f} (static "
          f"{pile['static_slots_per_world']}), dropped per frame "
          f"{pile['broad_phase_dropped_per_frame']}, vs CPU "
          f"{pile['vs_cpu']}, host syncs {pile['host_syncs_per_substep']}, "
          f"peak {pile['peak_memory_bytes'] / 2**30:.2f} GiB, "
          f"{pile['env_steps_per_s']:.1f} env-steps/s on {card}", flush=True)
    print(f"[47 SAP x {PILE_W}] {sap['checks']}, collide ms "
          f"{sap['collide_ms']} on {card}", flush=True)
    mark("46-47")

    man = phase_manifolds(dev)
    results["manifolds"] = man
    print("[48 persistent manifolds] " + "; ".join(
        f"{k}: launches {v['launches']}, gates {v['gates']}, vs CPU "
        f"{v['vs_cpu']}, B1 d={v['b1']['d']} {v['b1']['ms']:.4f} ms"
        + (f", B2 {v['b2']['shape']} {v['b2']['instance']} lam err "
           f"{v['b2']['lam_err']:.3g} {v['b2']['ms']:.4f} ms"
           if "b2" in v else "")
        + f", host syncs {v['host_syncs_per_substep']}, "
        f"{v['env_steps_per_s']:.1f} env-steps/s" for k, v in man.items())
        + f" on {card}", flush=True)
    mark("48")

    ter = phase_terrain(dev)
    results["terrain"] = ter
    print(f"[49 terrain ant x {TERRAIN_W}, replicate + SolverMuJoCo.step, "
          f"the main path] setup {ter['setup_s']:.1f} s (finalize "
          f"{ter['finalize_s']:.1f} s), SDF pool {ter['sdf_pool_bytes']} B, "
          f"slots a world {ter['slots_per_world']:.0f}, launches "
          f"{ter['launches']}, gates {ter['gates']}, B1 d={ter['b1']['d']} "
          f"{ter['b1']['ms']:.4f} ms, B2 {ter['b2']['shape']} "
          f"{ter['b2']['instance']} {ter['b2']['ms']:.4f} ms, paths "
          f"{ter['paths']}, vs CPU {ter['vs_cpu']}, mesh samples dropped "
          f"{ter['mesh_samples_dropped']}, host syncs "
          f"{ter['host_syncs_per_substep']}, device ms a substep "
          f"{ter['profile'] and ter['profile'].get('device_busy_ms')}, busy "
          f"{ter['busy_share_unprofiled']}, peak "
          f"{ter['peak_memory_bytes'] / 2**30:.2f} GiB, "
          f"{ter['env_steps_per_s']:.1f} env-steps/s (plain "
          f"{ter['plain_env_steps_per_s']:.1f}) on {card}", flush=True)
    mark("49")

    mesh = phase_mesh_scenes(dev)
    results["mesh_scenes"] = mesh
    print(f"[50 mesh scenes x {MESH_W}] " + "; ".join(
        f"{k}: gates {v['gates']}, vs CPU {v['vs_cpu']}, host syncs "
        f"{v['host_syncs_per_substep']}, setup {v['setup_s']:.1f} s, "
        f"{v['env_steps_per_s']:.1f} env-steps/s"
        for k, v in mesh.items()) + f" on {card}", flush=True)
    mark("50")

    hp = phase_pile_hulls(dev)
    results["hull_pile"] = hp
    print(f"[51 hull pile, 512 hulls, dynamic SAP] gates {hp['gates']}, "
          f"dropped per frame {hp['broad_phase_dropped_per_frame']}, classes "
          f"{hp['classes']}, vs CPU {hp['vs_cpu']}, host syncs "
          f"{hp['host_syncs_per_substep']}, "
          f"{hp['env_steps_per_s']:.1f} env-steps/s on {card}", flush=True)
    mark("51")

    vbd52 = phase_vbd_rigid(dev)
    results["vbd_rigid"] = vbd52
    st52 = vbd52["stack"]
    print(f"[52 AVBD, the slice's main path] VBD box stack x {VBD_W}: setup "
          f"{st52['setup_s']:.1f} s, launches {st52['launches']} in "
          f"{st52['substeps']} substeps, gates {st52['gates']}, vs CPU "
          f"{st52['vs_cpu']}, B1 solve d={st52['b1']['d']} W="
          f"{st52['b1']['W']} {st52['b1']['ms']:.4f} ms (plain "
          f"{st52['b1']['plain_ms']:.4f} ms, torch.linalg.solve "
          f"{st52['b1']['library_ms']:.4f} ms), aten calls a substep "
          f"{st52['aten_ops_per_substep']}, profiled substep "
          f"{st52['profile']}, busy {st52['busy_share_unprofiled']}, host "
          f"syncs {st52['host_syncs_per_substep']}, "
          f"{st52['env_steps_per_s']:.1f} env-steps/s; pendulum x "
          f"{PENDULUM_W}: length err {vbd52['pendulum']['length_err_max']:.3g}"
          f", {vbd52['pendulum']['env_steps_per_s']:.1f} env-steps/s; rod x "
          f"{ROD_VBD_W}: {vbd52['rod']['runs']} on {card}", flush=True)
    mark("52")

    cpl = phase_coupled(dev)
    results["coupled"] = cpl
    print("[53 SolverCoupled] " + "; ".join(
        f"{k}: launches {v['launches']} in {v['substeps']} eager substeps, "
        f"gates {v['gates']}, residuals {v.get('residuals')}, vs CPU "
        f"{v['vs_cpu']}, host syncs {v['host_syncs_per_substep']}, busy "
        f"{v['busy_share_unprofiled']}, {v['env_steps_per_s']:.1f} "
        f"env-steps/s" for k, v in cpl.items())
        + f"; tower z at frame 4 {cpl['tower']['box_z_frame_4']} on "
        f"{card}", flush=True)
    mark("53")

    pol = phase_policy_ant(dev)
    results["policy_ant"] = pol
    print(f"[54 ONNX-policy ant x {POLICY_W}, the RL layer, the main path] "
          f"setup {pol['setup_s']:.1f} s, launches {pol['launches']} in "
          f"{pol['substeps']} substeps, gates {pol['gates']}, worlds reset "
          f"{pol['worlds_reset']}, kernel vs plain frame {pol['paths']}, B1 "
          f"d={pol['b1']['d']} {pol['b1']['ms']:.4f} ms (plain "
          f"{pol['b1']['plain_ms']:.4f} ms, torch.linalg.solve "
          f"{pol['b1']['library_ms']:.4f} ms), B2 {pol['b2']['shape']} "
          f"{pol['b2']['instance']} {pol['b2']['ms']:.4f} ms (plain "
          f"{pol['b2']['plain_ms']:.4f} ms), host syncs a frame "
          f"{pol['host_syncs_per_frame']}, device ms a frame "
          f"{pol.get('device_ms_per_frame')}, device ops a frame "
          f"{pol.get('device_ops_per_frame')}, busy "
          f"{pol['busy_share_unprofiled']}, policy {pol['policy_ms']:.4f} "
          f"ms, sensors {pol['sensor_ms']:.4f} ms, frame "
          f"{pol['frame_ms']:.2f} ms, {pol['env_steps_per_s']:.1f} "
          f"env-steps/s on {card}", flush=True)
    mark("54")

    fr = phase_franka(dev)
    results["franka"] = fr
    if fr is None:
        print("[55 mesh-geom Franka] skipped: gymnasium-robotics' assets "
              "are not installed here (no gymnasium_robotics package, no "
              "$GYMNASIUM_ROBOTICS_ASSETS)", flush=True)
    else:
        print(f"[55 mesh-geom Franka] import {fr['import_s']:.1f} s, "
              f"finalize {fr['finalize_s']:.1f} s, counts {fr['counts']}, "
              f"IK {fr['targets']} targets x 2 seeds x 12 iterations: "
              f"{fr['solves_per_s']:.1f} solves/s, reach error median "
              f"{fr['reach_err_median']:.4g} max {fr['reach_err_max']:.4g};"
              f" kitchen {fr['kitchen']}, Adroit pen {fr['adroit_pen']} on "
              f"{card}", flush=True)
    mark("55")

    cam, main_cam = phase_camera_ant(dev)
    results["camera_ant"] = cam
    par = cam["parity"]
    print(f"[56 camera ant x {CAM_W}, the main path] setup "
          f"{cam['setup_s']:.1f} s, launches (B1, B1 solve, B2, K1, K2) "
          f"{cam['launches']} in {cam['substeps']} substeps, gates "
          f"{cam['gates']}, {cam['env_steps_per_s']:.1f} env-steps/s with "
          f"rendering, frame {cam['frame_ms']:.2f} ms, render "
          f"{cam['render_ms']:.2f} ms, K1 R={cam['k1']['rays']} "
          f"S={cam['k1']['shapes']} {cam['k1']['ms']:.3f} ms queued, "
          f"{cam['k1']['ms_unqueued']:.3f} ms back to back, work "
          f"{cam['k1']['work']} (plain "
          f"{cam['k1']['plain_ms']:.2f} ms on {CAM_PLAIN_RAYS} rays, K1 "
          f"{cam['k1']['ms_on_plain_rays']:.4f} ms there; K1 vs plain "
          f"there {cam['k1']['compare']}), host syncs a "
          f"frame {cam['host_syncs_per_frame']}, device ms a frame "
          f"{cam.get('device_ms_per_frame')}, device ops a frame "
          f"{cam.get('device_ops_per_frame')}, busy "
          f"{cam['busy_share_unprofiled']}; K1 vs plain x {CAM_PARITY_W}: "
          f"primary {par['primary']}, shadow {par['shadow']}, "
          f"{par['ms']:.4f} ms vs plain {par['plain_ms']:.2f} ms on {card}",
          flush=True)
    mark("56")

    cpaths = phase_camera_paths(dev, main_cam)
    results["camera_paths"] = cpaths
    del main_cam
    k2 = cpaths["k2"]
    print(f"[57 camera paths] shadows {cpaths['shadows']}; terrain mesh, "
          f"heightfield and splats: setup {cpaths['setup_s']:.1f} s, "
          f"launches (K1, K2) {cpaths['launches']}, mesh pixels "
          f"{cpaths['mesh_pixels']}, heightfield pixels "
          f"{cpaths['heightfield_pixels']}, splat alpha max "
          f"{cpaths['splat_alpha_max']:.3f}, render "
          f"{cpaths['render_ms']:.1f} ms; K1 {cpaths['k1']['ms']:.3f} ms; "
          f"K2 R={k2['rays']} T={k2['triangles']} {k2['ms']:.4f} ms "
          f"(J3's first design {FIRST_DESIGN_MS['K2']} ms, PERF.md; "
          f"visited {k2['visited']}; registers and blocks per SM "
          f"{k2['info']}; ptxas {k2['ptxas']}), vs plain on "
          f"{k2['plain_rays']} rays "
          f"t err {k2['t_max_abs_err']:.3g} n err {k2['n_max_abs_err']:.3g} "
          f"bit-equal {k2['bit_equal']}, plain {k2['plain_ms']:.1f} ms vs "
          f"{k2['ms_on_plain_rays']:.4f} ms (J3's first design "
          f"{FIRST_DESIGN_MS['K2 plain rays']} ms), brute force t err "
          f"{k2['brute_kernel_t_err']:.3g}/{k2['brute_plain_t_err']:.3g}; "
          f"golden {cpaths['golden']}; viewers {cpaths['viewers']} on "
          f"{card}", flush=True)
    mark("57")

    grad, (gmodel, _, _, ant_rec) = phase_grad_ant(dev)
    results["grad_ant"] = grad
    kv = grad["kernel_vs_plain"]
    print(f"[58 gradient-trained ant x {GRAD_W}, the main path] setup "
          f"{grad['setup_s']:.1f} s, {GRAD_STEPS} Adam steps of "
          f"{grad['substeps']} substeps, launches {grad['launches']}, gates "
          f"{grad['gates']}, loss {grad['losses'][0]:.5f} -> "
          f"{grad['loss_after']:.5f}, worlds with an active contact row "
          f"{grad['active_world_share']}, {grad['train_steps_per_s']:.3f} "
          f"train steps/s, {grad['env_steps_per_s']:.1f} env-steps/s "
          f"(forward + backward), forward {grad['forward_ms']:.1f} ms, "
          f"backward {grad['backward_ms']:.1f} ms (ratio "
          f"{grad['backward_over_forward']:.3f}), peak memory "
          f"{grad['peak_memory_bytes'] / 1e9:.2f} GB (checkpointed: "
          f"{grad['checkpointed']}); kernel vs plain gradient "
          f"{kv['rel_err']:.3g} (bound {kv['bound']:g}, all worlds "
          f"{kv['rel_err_all_worlds']:.3g}, halving mismatch worlds "
          f"{kv['halving_mismatch_worlds']}); repeat max diff "
          f"{grad['repeat_max_abs_diff']:.3g}; host syncs "
          f"{grad['host_syncs']}; profiled train step "
          f"{grad.get('profile')} on {card}", flush=True)
    gk = phase_grad_kernels(dev, ant_rec)
    results["grad_kernels"] = gk
    del gmodel, ant_rec

    def first_k3(c):
        return FIRST_DESIGN_MS[f"K3 {c['which']} d={c['d']}"]
    print("[58 (a) K3] " + "; ".join(
        f"{c['which']} d={c['d']} W={c['W']} [{c['instance']}]: "
        f"{c['ms']:.4f} ms (J3's first design {first_k3(c)} ms, PERF.md; "
        f"bound {c['bound_ms']:.4f} ms by {c['bound_by']}, share "
        f"{c['share_of_bound']:.3f}), plain backward {c['plain_ms']:.3f} "
        f"ms, torch.linalg.solve backward {c['library_ms']:.4f} ms, errors "
        f"{c['errors']}" for c in gk["k3"]) + f"; registers and blocks per "
        f"SM {gk['k3_info']}; ptxas {gk['k3_ptxas']} on {card}", flush=True)
    print("[58 (b) K4] " + "; ".join(
        f"{k}: worst rel {v['worst']:.3g}, halving mismatch "
        f"{v['halving_mismatch_envs']}, NaN pattern equal "
        f"{v['nan_pattern_equal']}, finite in other envs "
        f"{v['finite_in_other_envs']}" for k, v in gk["k4"].items())
        + "; times " + "; ".join(
            f"{k}: K4 {t[0]:.4f} ms, plain backward {t[1]:.3f} ms"
            for k, t in gk["k4_times"].items())
        + f"; registers and blocks per SM {gk['k4_info']}; ptxas "
        f"{gk['k4_ptxas']}; B2's saved "
        f"forward {gk['save_bytes_per_train_step'] / 1e6:.1f} MB a train "
        f"step; B2 with the save bit-equal to without "
        f"{gk['b2_save_bit_equal']} on {card}", flush=True)
    mark("58")

    usd, usd_trace = phase_usd_ant(dev)
    results["usd_ant"] = usd
    print("[59 tracer] EventTracer(sync=True) stages of the USD ant: "
          + "; ".join(usd_trace.splitlines()), flush=True)
    print(f"[59 USD ant x {USD_W}, the main path] setup "
          f"{usd['setup_s']:.2f} s (.usdc {usd['usdc_bytes']} bytes, the "
          f"model equal to the .usda's bit for bit), counts "
          f"{usd['counts']}, {usd['substeps']} substeps, launches "
          f"{usd['launches']}, gates {usd['gates']}, checkpoint "
          f"{usd['checkpoint']}, kernel vs plain frame {usd['paths']}, B1 "
          f"d={usd['b1']['d']} {usd['b1']['ms']:.4f} ms (plain "
          f"{usd['b1']['plain_ms']:.4f} ms, torch.linalg.solve "
          f"{usd['b1']['library_ms']:.4f} ms, err "
          f"{usd['b1']['max_abs_err']:.3g}), B2 {usd['b2']['shape']} "
          f"{usd['b2']['instance']} {usd['b2']['ms']:.4f} ms (plain "
          f"{usd['b2']['plain_ms']:.4f} ms, lam err "
          f"{usd['b2']['lam_err']:.3g}, guard mismatch rows "
          f"{usd['b2']['guard_mismatch_rows']}), envs with an active "
          f"contact {usd['active_contact_envs']}, 4 worlds vs the CPU "
          f"{usd['vs_cpu']}, host syncs a frame "
          f"{usd['host_syncs_per_frame']}, device ms a frame "
          f"{usd.get('device_ms_per_frame')}, device ops a frame "
          f"{usd.get('device_ops_per_frame')}, busy "
          f"{usd['busy_share_unprofiled']}, frame {usd['frame_ms']:.2f} ms, "
          f"{usd['env_steps_per_s']:.1f} env-steps/s on {card}", flush=True)
    mark("59")

    exm = phase_examples_main(dev)
    results["examples_main"] = exm
    print(f"[60 (a) humanoid batch x {EX_W} through the examples' "
          f"registry, the main path] setup {exm['setup_s']:.2f} s, "
          f"{exm['substeps']} substeps, launches {exm['launches']}, gates "
          f"{exm['gates']}, kernel vs plain frame {exm['paths']}, B1 "
          f"d={exm['b1']['d']} {exm['b1']['ms']:.4f} ms (plain "
          f"{exm['b1']['plain_ms']:.4f} ms, torch.linalg.solve "
          f"{exm['b1']['library_ms']:.4f} ms, err "
          f"{exm['b1']['max_abs_err']:.3g}), B2 {exm['b2']['shape']} "
          f"{exm['b2']['instance']} {exm['b2']['ms']:.4f} ms (plain "
          f"{exm['b2']['plain_ms']:.4f} ms, lam err "
          f"{exm['b2']['lam_err']:.3g}), envs with an active contact "
          f"{exm['active_contact_envs']}, 4 worlds vs the CPU "
          f"{exm['vs_cpu']}, host syncs a frame "
          f"{exm['host_syncs_per_frame']}, device ms a frame "
          f"{exm.get('device_ms_per_frame')}, device ops a frame "
          f"{exm.get('device_ops_per_frame')}, busy "
          f"{exm['busy_share_unprofiled']}, frame {exm['frame_ms']:.2f} ms, "
          f"{exm['env_steps_per_s']:.1f} env-steps/s on {card}", flush=True)
    rest, cli, sand = phase_examples_rest(dev)
    b34x = phase_examples_b34(dev, sand)
    del sand
    results.update(examples_rest=rest, examples_cli=cli, examples_b34=b34x)
    print("[60 (b) the other examples through main(), --test] " + "; ".join(
        f"{n}: {r['s']:.2f} s, {r['frames']} frames"
        f"{'' if r['test_final'] else ' (cut to 8, test_final not run: the phase time)'}, launches "
        f"{r['launches']}" for n, r in rest.items())
        + f"; B3/B4 at mpm_sand's N={b34x['N']}: p2g {b34x['p2g_ms']:.4f} "
        f"ms (plain {b34x['p2g_plain_ms']:.4f} ms, err "
        f"{b34x['p2g_max_abs_err']:.3g}), g2p {b34x['g2p_ms']:.4f} ms "
        f"(plain {b34x['g2p_plain_ms']:.4f} ms, err "
        f"{b34x['g2p_max_abs_err']:.3g}) on {card}", flush=True)
    print(f"[60 (c) python -m newton_tpu_torch.examples robot_ant --viewer "
          f"null --num-frames 4 --test] {cli}", flush=True)
    mark("60")

    results["kernel_info"] = kernel_info()
    print("[phase seconds] " + json.dumps(
        {k: round(v, 1) for k, v in results["phase_s"].items()}), flush=True)
    print("[details] " + json.dumps(results, default=str), flush=True)
    hcases = hpaths["cases"].values()

    no_library = ("no single PyTorch call computes this function: {}")
    pgs_ant = dict(c=25, nl=8, d=14, W=W)
    kernels = [
        dict(name="chol_inv_solve", route="cuda",
             source="newton_tpu_torch/csrc/chol_inv_solve.cu",
             replaces="newton_tpu/solvers/generalized/linalg_pallas.py:91",
             launches=main_res["launches"]["chol_inv_solve"],
             max_abs_err=b1["max_abs_err"], ms=b1["ms"],
             plain_ms=b1["plain_ms"],
             **bound_fields("chol_inv_solve", b1["ms"], d=14, W=W),
             library_ms=b1["library_ms"],
             library="torch.linalg.solve(Mi, [I | rhs])",
             humanoid_launches=hum["launches"]["chol_inv_solve"],
             humanoid_max_abs_err=max(v["chol"] for v in hcases),
             humanoid_ms=ht["b1_ms"], humanoid_plain_ms=ht["b1_plain_ms"],
             **bound_fields("chol_inv_solve", ht["b1_ms"], "humanoid_",
                            d=23, W=HUMANOID_W),
             humanoid_library_ms=ht["b1_library_ms"]),
        dict(name="pgs_solve_fused", route="cuda",
             source="newton_tpu_torch/csrc/pgs_solve.cu",
             replaces="newton_tpu/solvers/generalized/pgs_pallas.py:204",
             launches=main_res["launches"]["pgs_solve_fused"],
             max_abs_err=b2["max_abs_err"], ms=b2["ms"],
             plain_ms=b2["plain_ms"],
             **bound_fields("pgs_solve_fused", b2["ms"], **pgs_ant),
             library_ms=None, library=no_library.format(
                 "a projected-Jacobi contact solve with a per-env "
                 "divergence guard"),
             humanoid_launches=hum["launches"]["pgs_solve_fused"],
             humanoid_max_abs_err=max(v["pgs_lam"] for v in hcases),
             humanoid_ms=ht["b2_ms"], humanoid_plain_ms=ht["b2_plain_ms"],
             **bound_fields("pgs_solve_fused", ht["b2_ms"], "humanoid_",
                            c=32, nl=17, d=23, W=HUMANOID_W),
             humanoid_uncompacted_ms=ht["b2_uncompacted_ms"],
             humanoid_uncompacted_plain_ms=ht["b2_uncompacted_plain_ms"],
             **bound_fields("pgs_solve_fused", ht["b2_uncompacted_ms"],
                            "humanoid_uncompacted_", c=192, nl=17, d=23,
                            W=HUMANOID_W)),
        dict(name="mpm_p2g", route="cuda",
             source="newton_tpu_torch/csrc/mpm_transfer.cu",
             replaces="newton_tpu/solvers/mpm_pallas.py:82",
             launches=mpm["launches"]["p2g_apply"],
             max_abs_err=b34["p2g_max_abs_err"], ms=b34["p2g_ms"],
             plain_ms=b34["p2g_plain_ms"],
             **bound_fields("mpm_p2g", b34["p2g_ms"], N=MPM_N, C=13,
                            res=MPM_RES),
             library_ms=None, library=no_library.format(
                 "the 27-node B-spline weights times the values, scattered "
                 "(index_add_ alone does only the scatter)"),
             timed="with its binning (bin_particles), as a call without "
                   "bins runs",
             ms_given_bins=b34["p2g_given_bins_ms"],
             **bound_fields("mpm_p2g", b34["p2g_given_bins_ms"],
                            "given_bins_", N=MPM_N, C=13, res=MPM_RES),
             binning_ms=b34["bin_ms"],
             binning_launches=mpm["launches"]["bin_particles"]),
        dict(name="mpm_g2p", route="cuda",
             source="newton_tpu_torch/csrc/mpm_transfer.cu",
             replaces="newton_tpu/solvers/mpm_pallas.py:126",
             launches=mpm["launches"]["g2p_apply"],
             max_abs_err=b34["g2p_max_abs_err"], ms=b34["g2p_ms"],
             plain_ms=b34["g2p_plain_ms"],
             **bound_fields("mpm_g2p", b34["g2p_ms"], N=MPM_N, C=12,
                            active_nodes=b34["active_nodes"]),
             library_ms=None, library=no_library.format(
                 "the 27-node B-spline weighted gather"),
             timed="given the step's bins, as the main path calls it",
             active_nodes=b34["active_nodes"],
             ms_with_binning=b34["g2p_with_binning_ms"]),
        dict(name="mpm_bin_particles", route="cuda",
             source="newton_tpu_torch/csrc/mpm_transfer.cu",
             replaces="newton_tpu/solvers/mpm_pallas.py:82",
             part_of="the ports of p2g_apply and g2p_apply (the TPU kernels "
                     "take the particles in any order)",
             launches=mpm["launches"]["bin_particles"],
             max_abs_err=0.0, ms=b34["bin_ms"],
             plain_ms=b34["bin_plain_ms"],
             **bound_fields("mpm_bin", b34["bin_ms"], N=MPM_N,
                            tiles=b34["tiles"],
                            active_tiles=b34["active_tiles"]),
             library_ms=b34["bin_library_ms"],
             library="torch.sort(tile keys, stable=True), keys made "
                     "outside the timed window"),
    ]
    b1_src = dict(
        route="cuda", source="newton_tpu_torch/csrc/chol_inv_solve.cu",
        replaces="newton_tpu/solvers/generalized/linalg_pallas.py:91",
        library="torch.linalg.solve(Mi, [I | rhs])")
    b2_src = dict(route="cuda", source="newton_tpu_torch/csrc/pgs_solve.cu",
                  replaces="newton_tpu/solvers/generalized/pgs_pallas.py:204",
                  library_ms=None, library=no_library.format(
                      "a projected-Jacobi contact solve with a per-env "
                      "divergence guard"))
    c40, c165 = chains[40], chains[165]
    for label, path, d, n, launches, err, t in (
            ("reg8", "cartpole x 8192, replicate + step (phase 13)", 2,
             WORLDS, cart["launches"]["chol_inv_solve"],
             cart["b1_max_abs_err"], cart["b1"]),
            ("reg23", "humanoid x 8192, replicate + step (phase 14)", 23,
             WORLDS, hw["launches"]["chol_inv_solve"], hw["b1_max_abs_err"],
             hw["times"]["b1"]),
            ("generic_smem", "40-link chain, step_batched (phase 15)", 45,
             c40["envs"], c40["launches"]["chol_inv_solve"],
             c40["b1_max_abs_err"], c40["b1"]),
            ("generic_global", "165-link chain, step_batched (phase 15)",
             170, c165["envs"], c165["launches"]["chol_inv_solve"],
             c165["b1_max_abs_err"], c165["b1"]),
            ("reg16", "half_cheetah x 4096, step_batched (phase 16)", 9,
             PLANAR_W, cheetah["launches"]["chol_inv_solve"],
             cheetah["b1_max_abs_err"], cheetah["b1"]),
            ("reg8", "hopper x 8192, replicate + step, RK4: 4 per substep "
             "(phase 17)", 6, WORLDS, hop["launches"]["chol_inv_solve"],
             hop["b1_max_abs_err"], hop["b1"]),
            ("reg24", "rod x 4096, ball joints (phase 18)", 21, HETERO_W,
             rod["launches"]["chol_inv_solve"], rod["b1_max_abs_err"],
             rod["b1"]),
            ("reg14", "ant with a ball x 4096, the ant's group: 2 groups "
             "per substep (phase 19)", 14, HETERO_W,
             ab["launches"]["chol_inv_solve"],
             ab["paths"]["b1 group 0"][0], ab["times"][0]["b1"]),
            ("reg8", "ant with a ball x 4096, the ball's group (phase 19)",
             6, HETERO_W, ab["launches"]["chol_inv_solve"],
             ab["paths"]["b1 group 1"][0], ab["times"][1]["b1"])):
        kernels.append(dict(
            name=f"chol_inv_solve [{label}] d={d} W={n}", **b1_src,
            instance=label, path=path, launches=launches, max_abs_err=err,
            ms=t["ms"], plain_ms=t["plain_ms"],
            **bound_fields("chol_inv_solve", t["ms"], d=d, W=n),
            library_ms=t["library_ms"]))
    for label, path, shape, n, launches, err, ms, plain_ms in (
            ("reg24", "humanoid x 8192, replicate + step (phase 14)",
             (32, 17, 23), WORLDS, hw["launches"]["pgs_solve_fused"],
             hw["paths"]["pgs_lam"], hw["times"]["b2_ms"],
             hw["times"]["b2_plain_ms"]),
            ("smem256", "40-link chain, step_batched (phase 15)",
             c40["b2_shape"], c40["envs"], c40["launches"]["pgs_solve_fused"],
             c40["pgs_lam_err"], c40["b2_ms"], c40["b2_plain_ms"]),
            ("global256", "165-link chain, step_batched (phase 15)",
             c165["b2_shape"], c165["envs"],
             c165["launches"]["pgs_solve_fused"], c165["pgs_lam_err"],
             c165["b2_ms"], c165["b2_plain_ms"]),
            ("smem128", "half_cheetah x 4096, step_batched (phase 16)",
             (16, 6, 9), PLANAR_W, cheetah["launches"]["pgs_solve_fused"],
             cheetah["pgs_lam_err"], cheetah["b2_ms"],
             cheetah["b2_plain_ms"]),
            ("smem128", "hopper x 8192, replicate + step, RK4 (phase 17)",
             (14, 3, 6), WORLDS, hop["launches"]["pgs_solve_fused"],
             hop["pgs_lam_err"], hop["b2_ms"], hop["b2_plain_ms"])):
        c, nl, d = shape
        kernels.append(dict(
            name=f"pgs_solve_fused [{label}] {shape} W={n}", **b2_src,
            instance=label, path=path, launches=launches, max_abs_err=err,
            ms=ms, plain_ms=plain_ms,
            **bound_fields("pgs_solve_fused", ms, c=c, nl=nl, d=d, W=n)))
    for gi, label in ((0, "the ant's group"), (1, "the ball's group")):
        t = ab["times"][gi]
        c, nl, d = t["b2_shape"]
        kernels.append(dict(
            name=f"pgs_solve_fused [{t['b2_instance']}, w_other] "
                 f"{t['b2_shape']} W={HETERO_W}", **b2_src,
            instance=t["b2_instance"],
            path=f"ant with a ball x 4096, {label}, two-sided contacts: "
                 "2 groups per substep (phase 19)",
            launches=ab["launches"]["pgs_solve_fused"],
            max_abs_err=ab["paths"][f"b2 group {gi}"]["lam"],
            ms=t["b2_ms"], plain_ms=t["b2_plain_ms"],
            **bound_fields("pgs_solve_fused", t["b2_ms"], c=c, nl=nl, d=d,
                           W=HETERO_W, w_other=True)))
    c, nl, d = rg["b2_shape"]
    kernels.append(dict(
        name=f"pgs_solve_fused [{rg['b2_instance']}] {rg['b2_shape']} "
             f"W={SHOWCASE_W}", **b2_src, instance=rg["b2_instance"],
        path="ragged pedestal plan x 1024 (phase 20)",
        launches=rg["launches"]["pgs_solve_fused"],
        max_abs_err=rg["paths"]["b2 group 0"]["lam"], ms=rg["b2_ms"],
        plain_ms=rg["b2_plain_ms"],
        **bound_fields("pgs_solve_fused", rg["b2_ms"], c=c, nl=nl, d=d,
                       W=SHOWCASE_W)))
    for label, path, d, n, launches, err, t in (
            (pyr["b1_instance"], "pyramid x 1024 on SolverFeatherstone, "
             "box rows (phase 22)", 36, BOX_W,
             pyr["launches"]["chol_inv_solve"], pyr["b1_max_abs_err"],
             pyr["b1"]),):
        kernels.append(dict(
            name=f"chol_inv_solve [{label}] d={d} W={n}", **b1_src,
            instance=label, path=path, launches=launches, max_abs_err=err,
            ms=t["ms"], plain_ms=t["plain_ms"],
            **bound_fields("chol_inv_solve", t["ms"], d=d, W=n),
            library_ms=t["library_ms"]))
    unc = pyr["uncompacted"]
    for label, path, shape, launches, err, ms, plain_ms in (
            (pyr["b2_instance"], "pyramid x 1024 on SolverFeatherstone, "
             "288 box entries compacted to 32 (phase 22)", (32, 0, 36),
             pyr["launches"]["pgs_solve_fused"], pyr["pgs_lam_err"],
             pyr["b2_ms"], pyr["b2_plain_ms"]),
            ("global256", "pyramid x 1024 with contact_cap=0, every box "
             "entry: one substep (phase 22)", (288, 0, 36),
             unc["launches"][1], unc["lam_err"], unc["ms"],
             unc["plain_ms"])):
        c, nl, d = shape
        kernels.append(dict(
            name=f"pgs_solve_fused [{label}] {shape} W={BOX_W}", **b2_src,
            instance=label, path=path, launches=launches, max_abs_err=err,
            ms=ms, plain_ms=plain_ms,
            **bound_fields("pgs_solve_fused", ms, c=c, nl=nl, d=d,
                           W=BOX_W, iters=16)))
    kernels += slice_kernel_entries(eq, ws, urdf, b1_src, b2_src)
    kernels += rest_kernel_entries(nqp, imp, ten, mus, kam, b1_src, b2_src)
    kernels += free_body_kernel_entries(conv, mnt, tower, b1_src, b2_src)
    kernels += shape_kernel_entries(man, b1_src, b2_src)
    kernels += mesh_kernel_entries(ter, mesh, b1_src, b2_src)
    kernels += coupled_kernel_entries(vbd52, cpl, b1_src, b2_src)
    kernels += policy_kernel_entries(pol, b1_src, b2_src)
    kernels += camera_kernel_entries(cam, cpaths)
    kernels += grad_kernel_entries(grad, gk)
    kernels += usd_kernel_entries(usd, b1_src, b2_src)
    kernels += examples_kernel_entries(exm, b34x, b1_src, b2_src)
    print(f"[bounds] H100 SXM peaks {PEAK_BYTES_PER_S / 1e12:g} TB/s, "
          f"{PEAK_F32_FLOPS / 1e12:g} TFLOP/s float32 (700 W); this card: "
          f"{card}", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
