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
     env-steps/s in turns and the phase's peak device memory.
It prints one JSON line listing the kernels (name, route, source,
launches, error, times, and each time's least possible time on an H100
SXM at 700 W from ``kernel_cost``: bound_ms, bound_by, share_of_bound;
library_ms where one PyTorch call computes the same function, else null
with the reason; B1 and B2 also at the humanoid's shapes; B3 timed with
its binning and given bins, B4 given bins, its bound counted on the nodes
it reads; the binning, part of both, with its own entry; then one entry
for each B1 and B2 instance on the paths of phases 13-17, with W = 8192
where it runs there), then the card
line, then the result line ``{"ok": true,
"device": {...}}``. Any failed phase raises: exit code != 0 and no result
line. Without a CUDA device it exits 2 at once. A ``[details]`` line
carries the per-case errors, the throughput turns, the compiler's
register report and, for B1 and B2 at each main-path shape and each
kernel of B3, B4 and the binning, registers per thread and resident
blocks per SM (and shared memory per block).
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
    pgs_solve_fused (c, nl, d; iters = 8): reads J, Minv, qd, b, act,
        lam0 and mu, writes lam, dqd and the int32 halvings (the per-call
        ld vector is not per env); the MJ = J Minv assembly (3c d^2), diag
        and v_free (2 x 3c d), spectral_iters + iters Delassus matvecs
        (2 x 3c d + nl d each) and dqd (3c d + nl d).
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
    traffic and count in neither bound."""
    f = 4
    if name == "chol_inv_solve":
        d = shape["d"]
        nbytes = 2 * (d * d + d) * f
        fma = (d - 1) * d * (d + 1) // 6 + d * (d - 1) * (d + 1)
        flops = 2 * fma + 2 * d * (d + 1) + d
    elif name == "pgs_solve_fused":
        c, nl, d = shape["c"], shape["nl"], shape["d"]
        iters = shape.get("iters", 8)
        r3, r = 3 * c, 3 * c + 2 * nl
        spec = 3 if r < 192 else 8
        nbytes = (r3 * d + d * d + d + 3 * r + c) * f + (r + d) * f + 4
        fma = (r3 * d * d + 2 * r3 * d
               + (spec + iters) * (2 * r3 * d + nl * d) + r3 * d + nl * d)
        flops = 2 * fma
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


def time_ms(fn, n=50, queued=False):
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
    plain = state.clone()
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
    # throughput in turns, as phase 5; the plain path starts from the same
    # reset and warms up as the kernel path did
    plain = run_frames(model, pipe, solver, plain, sample, HUMANOID_WARMUP,
                       False)
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
        rates[kernels].append(n_sub * HUMANOID_W
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
    import torch
    ctl = model.control()
    for _ in range(frames):
        ctl.custom["mjc:ctrl"] = sample(1)[0]
        for _ in range(SUBSTEPS):
            contacts = pipe.collide(state)
            if touched is not None:
                touched |= contacts.rigid_contact_mask[
                    solver.tables.row_slots].any(1)
            state = solver.step(state, None, ctl, contacts, dt,
                                kernels=kernels)
    torch.cuda.synchronize()
    return state


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
    pgs.pgs_solve_fused.launches = 0


def flat_turns(model, pipe, solver, state, plain, sample, n, dt=DT):
    """env-steps/s of the kernel and plain paths in turns (plain, kernel,
    kernel, plain), each turn FRAMES frames continuing its own state; the
    plain turns launch no kernel."""
    rates = {True: [], False: []}
    n_sub = FRAMES * SUBSTEPS
    for kernels in (False, True, True, False):
        before = kernel_launches()
        t0 = time.perf_counter()
        if kernels:
            state = run_flat_frames(model, pipe, solver, state, sample,
                                    FRAMES, True, dt=dt)
        else:
            plain = run_flat_frames(model, pipe, solver, plain, sample,
                                    FRAMES, False, dt=dt)
        rates[kernels].append(n_sub * n / (time.perf_counter() - t0))
        if not kernels and kernel_launches() != before:
            raise AssertionError("a plain path launched a kernel")
    return rates, state, plain


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
    plain = state.clone()
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
    plain = run_flat_frames(model, pipe, solver, plain, sample,
                            HUMANOID_WARMUP, False)
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
            state = run_frames(model, pipe, solver, state, sample, FRAMES,
                               True)
        else:
            plain = run_frames(model, pipe, solver, plain, sample, FRAMES,
                               False)
        rates[kernels].append(n_sub * PLANAR_W / (time.perf_counter() - t0))
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
    plain = state.clone()
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
    plain = run_flat_frames(model, pipe, solver, plain, sample,
                            HOPPER_WARMUP, False, dt=HOPPER_DT)
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
            ("B2 (14, 3, 6)", lib.pgs_kernel_info, (14, 3, 6))):
        regs, blocks = ctypes.c_int(0), ctypes.c_int(0)
        _kernels.check(fn(*shape, ctypes.addressof(regs),
                          ctypes.addressof(blocks)), label)
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


def bound_fields(name, ms, prefix="", **shape):
    """bound_ms, bound_by and share_of_bound of one timed call at W envs."""
    t, by = bound_ms(*kernel_cost(name, **shape))
    return {f"{prefix}bound_ms": t, f"{prefix}bound_by": by,
            f"{prefix}share_of_bound": t / ms}


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
          f"err {b1['max_abs_err']:.3g}, normwise vs float64 "
          f"{b1['normwise']}; " + "; ".join(
              f"d={d} {t['ms']:.4f} ms vs plain {t['plain_ms']:.4f} ms, "
              f"torch.linalg.solve {t['library_ms']:.4f} ms"
              for d, t in b1["times"].items()), flush=True)

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
          f"1e-7 of float64, N={MPM_N} res={MPM_RES}, cases "
          f"{b34['cases']}; p2g max abs err {b34['p2g_max_abs_err']:.3g}, "
          f"{b34['p2g_ms']:.4f} ms with its binning, "
          f"{b34['p2g_given_bins_ms']:.4f} ms given bins, binning "
          f"{b34['bin_ms']:.4f} ms, plain {b34['p2g_plain_ms']:.4f} ms; g2p "
          f"max abs err {b34['g2p_max_abs_err']:.3g}, {b34['g2p_ms']:.4f} ms "
          f"given bins ({b34['g2p_with_binning_ms']:.4f} ms with its "
          f"binning), plain {b34['g2p_plain_ms']:.4f} ms; sand stencils "
          f"touch {b34['active_nodes']} nodes", flush=True)

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

    results["kernel_info"] = kernel_info()
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
             hop["b1_max_abs_err"], hop["b1"])):
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
