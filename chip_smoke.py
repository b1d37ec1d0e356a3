#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, one line each:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: compiles the CUDA kernels in newton_tpu_torch/csrc with nvcc;
  3. B1: the Cholesky/solve/inverse kernel vs its plain PyTorch version,
     W = 4096, d in {14, 23};
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
     drawn over -2..res (border clipping) and on the real sand state's;
  8. MPM main path: bench.py --mode mpm's sand (32768 particles uniform in
     [-0.3, 0.3]^2 x [0.05, 0.8], mass 0.002, grid (-1, -1, 0)-(1, 1, 2) at
     res 64, friction 0.6, young 5e4, explicit, dt 4e-4), 25 warm-up steps
     then 100 checked steps with exactly one launch of each kernel per
     step, finite state, min z > -0.05, |x|, |y| < 1 and a falling mean z,
     then particle-steps/s on the kernel and plain paths in turns;
  9. the CG (implicit_iterations = 8) and implicit-rheology paths, 10
     steps each at the same size, with their launch counts per step
     (1 + 9 of each kernel for CG, 1 for the rheology path);
 10. one MPM step through the kernels, one through the plain versions and
     one plain step in float64, from the same cloned sand state: the two
     float32 paths agree with each other and with float64 to q 1e-6, qd
     1e-4, F 1e-5 and C 1e-3 max(1, max |C|).
It prints one JSON line listing the kernels (name, route, source,
launches, error, times), then the card line, then the result line
``{"ok": true, "device": {...}}``. Any failed phase raises: exit code != 0
and no result line. Without a CUDA device it exits 2 at once. A
``[details]`` line carries the per-case errors, the throughput turns and
the compiler's register report.
"""

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
ITERS = 8


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


def time_ms(fn, n=50):
    """Mean device time of one call, CUDA events around n calls."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def phase_b1(dev):
    """Cholesky kernel vs plain on random SPD matrices (A A^T + 2 I)."""
    import numpy as np
    import torch
    from newton_tpu_torch.solvers.generalized import linalg
    rng = np.random.RandomState(1)
    out = {}
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
        if d == 14:
            ms = time_ms(lambda: linalg.chol_inv_solve(Mi, rhs))
            plain_ms = time_ms(lambda: linalg.chol_inv_solve_plain(Mi, rhs))
    return dict(max_abs_err=max(out.values()), per_d=out, ms=ms,
                plain_ms=plain_ms)


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
    return e1, e2, n_diff, int(h_p.sum())


def random_pgs_inputs(dev, c, nl, d, seed):
    """Random PGS operands shaped like the JAX package's interpret-mode
    test: J ~ N(0, 1), one SPD Minv for all envs, |b|, act ~ 70% on."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    r = 3 * c + 2 * nl
    Minv = rng.randn(d, d)
    Minv = (Minv @ Minv.T + np.eye(d)).astype(np.float32)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x, dtype=np.float32),
                               device=dev)
    args = (t(rng.randn(W, 3 * c, d)), t(np.broadcast_to(Minv, (W, d, d))),
            t(rng.randn(W, d)), t(np.abs(rng.randn(W, r))),
            t(rng.rand(W, r) > 0.3), t(np.abs(rng.rand(W, c))),
            t(np.zeros((W, r))))
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
        e1, e2, n_diff, n_halv = compare_pgs(args, kw, W // 1000)
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
    e1, e2, n_diff, n_halv = compare_pgs(args, kw, 0)
    cases["ant substep, drop 0.08"] = dict(
        lam_err=e1, dqd_err=e2, guard_mismatch_envs=n_diff,
        halvings=n_halv, max_active_contacts=n_active)
    worst_lam, worst_dqd = max(worst_lam, e1), max(worst_dqd, e2)
    ms = time_ms(lambda: pgs.pgs_solve_fused(*args, **kw))
    plain_ms = time_ms(lambda: pgs.pgs_solve_fused_plain(*args, **kw))
    return dict(max_abs_err=worst_lam, dqd_max_abs_err=worst_dqd,
                cases=cases, ms=ms, plain_ms=plain_ms), sb, ctrl


def run_frames(model, pipe, solver, state, sample, frames, kernels):
    import torch
    for _ in range(frames):
        ctl = batched_control(model, sample(W))
        for _ in range(SUBSTEPS):
            state = solver.step_batched(state, None, ctl, pipe.collide(state),
                                        DT, kernels=kernels)
    torch.cuda.synchronize()
    return state


def check_state(state, label):
    import torch
    for name in ("joint_q", "joint_qd", "body_q", "body_qd"):
        if not bool(torch.isfinite(getattr(state, name)).all()):
            raise AssertionError(f"{label}: non-finite {name}")
    qn = torch.linalg.vector_norm(state.body_q[..., 3:7], dim=-1)
    if float((qn - 1.0).abs().max()) > 1e-2:
        raise AssertionError(f"{label}: non-normalized quaternions")
    zmin = float(state.joint_q[:, 2].min())
    if zmin <= 0.1:
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
    # throughput in turns (plain, kernel, kernel, plain), each turn FRAMES
    # frames continuing its own path's state, so drift on the card hits
    # both paths alike
    plain = run_frames(model, pipe, solver, nt.batch_state(state0, W),
                       sample, 1, False)
    rates = {True: [], False: []}
    for kernels in (False, True, True, False):
        before = (linalg.chol_inv_solve.launches,
                  pgs.pgs_solve_fused.launches)
        t0 = time.perf_counter()
        if kernels:
            state = run_frames(model, pipe, solver, state, sample, FRAMES,
                               True)
        else:
            plain = run_frames(model, pipe, solver, plain, sample, FRAMES,
                               False)
        rates[kernels].append(n_sub * W / (time.perf_counter() - t0))
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
        ctl = batched_control(model, sample(W))
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
    return bool((diff <= 1e-5 * S + 1e-7).all()), float(diff.max())


def phase_b34(dev, solver, state):
    import numpy as np
    import torch
    from newton_tpu_torch.solvers import mpm_transfer as mt
    rng = np.random.RandomState(5)
    n, res = MPM_N, MPM_RES
    _, sand_base, sand_w = solver.stencil(state.particle_q)
    rand_base = torch.as_tensor(rng.randint(-2, res + 1, (n, 3)),
                                dtype=torch.int32, device=dev)
    rand_w = torch.as_tensor(rng.rand(n, 3, 3), dtype=torch.float32,
                             device=dev)
    vals = torch.as_tensor(rng.randn(n, 13), dtype=torch.float32, device=dev)
    grid = torch.as_tensor(rng.randn(res, res, res, 12), dtype=torch.float32,
                           device=dev)
    errs = {}
    for label, base, w in (("random", rand_base, rand_w),
                           ("sand", sand_base, sand_w)):
        w64 = w.double()
        ref_G = mt.p2g_apply_plain(base, w64, vals.double(), res)
        S_G = mt.p2g_apply_plain(base, w64, vals.double().abs(), res)
        ref_P = mt.g2p_apply_plain(base, w64, grid.double())
        S_P = mt.g2p_apply_plain(base, w64, grid.double().abs())
        for name, got, ref, S in (
                ("p2g kernel", mt.p2g_apply(base, w, vals, res), ref_G, S_G),
                ("p2g plain", mt.p2g_apply_plain(base, w, vals, res), ref_G,
                 S_G),
                ("g2p kernel", mt.g2p_apply(base, w, grid), ref_P, S_P),
                ("g2p plain", mt.g2p_apply_plain(base, w, grid), ref_P,
                 S_P)):
            ok, e = transfer_err(got, ref, S)
            if not ok:
                raise AssertionError(f"B3/B4 {name} ({label} bases) vs the "
                                     f"float64 plain result: off tolerance, "
                                     f"max abs err {e:.3g}")
            errs[f"{name}, {label} bases"] = e
    out = dict(errors=errs,
               p2g_max_abs_err=max(v for k, v in errs.items()
                                   if k.startswith("p2g kernel")),
               g2p_max_abs_err=max(v for k, v in errs.items()
                                   if k.startswith("g2p kernel")))
    # times at the main path's shapes and access pattern (sand bases)
    out["p2g_ms"] = time_ms(lambda: mt.p2g_apply(sand_base, sand_w, vals,
                                                 res))
    out["p2g_plain_ms"] = time_ms(lambda: mt.p2g_apply_plain(
        sand_base, sand_w, vals, res))
    out["g2p_ms"] = time_ms(lambda: mt.g2p_apply(sand_base, sand_w, grid))
    out["g2p_plain_ms"] = time_ms(lambda: mt.g2p_apply_plain(
        sand_base, sand_w, grid))
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
                g2p_apply=mt.g2p_apply.launches)


def reset_mpm_launches():
    from newton_tpu_torch.solvers import mpm_transfer as mt
    mt.p2g_apply.launches = 0
    mt.g2p_apply.launches = 0


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
            if n != per_step * MPM_SIDE_STEPS:
                raise AssertionError(
                    f"MPM {label} path: {name} launched {n} times in "
                    f"{MPM_SIDE_STEPS} steps, expected {per_step} per step")
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


def main():
    import torch
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

    card = card_line()
    print(f"[1 device] {torch.cuda.get_device_name(0)}; nvidia-smi: {card}",
          flush=True)

    t0 = time.perf_counter()
    _kernels.lib()
    print(f"[2 build] {time.perf_counter() - t0:.1f} s "
          f"(nvcc sm_90a, ctypes)", flush=True)
    with open(os.path.join(os.path.dirname(_kernels.build()),
                           "ptxas.log")) as f:
        results["ptxas"] = [ln for ln in f.read().splitlines()
                            if "registers" in ln or "spill" in ln]

    b1 = phase_b1(dev)
    results["b1"] = b1
    print(f"[3 B1 chol_inv_solve] kernel == plain, d=14,23 W={W}, max abs "
          f"err {b1['max_abs_err']:.3g}; {b1['ms']:.4f} ms vs plain "
          f"{b1['plain_ms']:.4f} ms (d=14)", flush=True)

    model, pipe, solver, state0 = build_ant(dev)
    b2, dropped, _ = phase_b2(dev, model, pipe, solver, state0)
    results["b2"] = b2
    mism = {k: v["guard_mismatch_envs"] for k, v in b2["cases"].items()}
    print(f"[4 B2 pgs_solve_fused] kernel == plain, ant shapes W={W}, lam "
          f"err {b2['max_abs_err']:.3g}, dqd err {b2['dqd_max_abs_err']:.3g}"
          f"; guard-mismatch envs {mism}; {b2['ms']:.4f} ms vs plain "
          f"{b2['plain_ms']:.4f} ms", flush=True)

    main_res, final = phase_main(dev, model, pipe, solver, state0)
    results["main"] = main_res
    print(f"[5 main path] ant x {W} envs, {main_res['substeps']} substeps, "
          f"launches {main_res['launches']}, root z min "
          f"{main_res['root_z_min']:.3f}; {main_res['env_steps_per_s']:.1f} "
          f"env-steps/s (plain path {main_res['plain_env_steps_per_s']:.1f})"
          f" on {card}", flush=True)

    paths = phase_paths(model, pipe, solver,
                        {"main-path end": final, "drop 0.08": dropped},
                        ctrl_sampler(model, dev, seed=3))
    results["paths"] = paths
    print(f"[6 kernel vs plain substep] {paths}", flush=True)

    _, sand_solver, sand0 = build_sand(dev)
    b34 = phase_b34(dev, sand_solver, sand0)
    results["b34"] = b34
    print(f"[7 B3/B4 mpm p2g/g2p] kernels and plain f32 within 1e-5 S + "
          f"1e-7 of float64, N={MPM_N} res={MPM_RES}; p2g max abs err "
          f"{b34['p2g_max_abs_err']:.3g}, {b34['p2g_ms']:.4f} ms vs plain "
          f"{b34['p2g_plain_ms']:.4f} ms; g2p max abs err "
          f"{b34['g2p_max_abs_err']:.3g}, {b34['g2p_ms']:.4f} ms vs plain "
          f"{b34['g2p_plain_ms']:.4f} ms", flush=True)

    mpm, sand_end = phase_mpm_main(sand_solver, sand0)
    results["mpm"] = mpm
    print(f"[8 MPM main path] sand x {MPM_N} particles, res {MPM_RES}, "
          f"{mpm['steps']} steps, launches {mpm['launches']}, gates "
          f"{mpm['gates']}; {mpm['particle_steps_per_s']:.1f} "
          f"particle-steps/s (plain path "
          f"{mpm['plain_particle_steps_per_s']:.1f}) on {card}", flush=True)

    side = phase_mpm_side(dev)
    results["mpm_side"] = side
    print(f"[9 MPM CG and rheology paths] " + "; ".join(
        f"{k}: launches {v['launches']} in {MPM_SIDE_STEPS} steps "
        f"({v['per_step']} per step), {v['particle_steps_per_s']:.1f} "
        f"particle-steps/s" for k, v in side.items()), flush=True)

    mpm_paths = phase_mpm_paths(sand_solver, sand_end)
    results["mpm_paths"] = mpm_paths
    print(f"[10 kernel vs plain MPM step] max |C| "
          f"{mpm_paths['c_max']:.3g}; " + "; ".join(
              f"{k}: " + ", ".join(f"{a} {b:.3g}" for a, b in v.items())
              for k, v in mpm_paths["errors"].items()), flush=True)

    print("[details] " + json.dumps(results, default=str), flush=True)

    kernels = [
        dict(name="chol_inv_solve", route="cuda",
             source="newton_tpu_torch/csrc/chol_inv_solve.cu",
             replaces="newton_tpu/solvers/generalized/linalg_pallas.py:91",
             launches=main_res["launches"]["chol_inv_solve"],
             max_abs_err=b1["max_abs_err"], ms=b1["ms"],
             plain_ms=b1["plain_ms"]),
        dict(name="pgs_solve_fused", route="cuda",
             source="newton_tpu_torch/csrc/pgs_solve.cu",
             replaces="newton_tpu/solvers/generalized/pgs_pallas.py:204",
             launches=main_res["launches"]["pgs_solve_fused"],
             max_abs_err=b2["max_abs_err"], ms=b2["ms"],
             plain_ms=b2["plain_ms"]),
        dict(name="mpm_p2g", route="cuda",
             source="newton_tpu_torch/csrc/mpm_transfer.cu",
             replaces="newton_tpu/solvers/mpm_pallas.py:82",
             launches=mpm["launches"]["p2g_apply"],
             max_abs_err=b34["p2g_max_abs_err"], ms=b34["p2g_ms"],
             plain_ms=b34["p2g_plain_ms"]),
        dict(name="mpm_g2p", route="cuda",
             source="newton_tpu_torch/csrc/mpm_transfer.cu",
             replaces="newton_tpu/solvers/mpm_pallas.py:126",
             launches=mpm["launches"]["g2p_apply"],
             max_abs_err=b34["g2p_max_abs_err"], ms=b34["g2p_ms"],
             plain_ms=b34["g2p_plain_ms"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
