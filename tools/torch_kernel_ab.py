#!/usr/bin/env python3
"""Kernels of two checkouts of the PyTorch port, side by side on one CUDA
card.

    python3 tools/torch_kernel_ab.py [--parent DIR] [--mpm-only] [--out FILE]
    python3 tools/torch_kernel_ab.py --worlds [--out FILE]
    python3 tools/torch_kernel_ab.py --planar [--out FILE]
    python3 tools/torch_kernel_ab.py --hetero [--out FILE]

Builds this checkout's kernel library and, with ``--parent``, the library
of the checkout at DIR (its own ``newton_tpu_torch/csrc``), then on the same
operands, in turns (parent, this, this, parent):
  - times B1 (``chol_inv_solve_f32``) at d = 14 (random SPD) and d = 23
    (operands captured from a humanoid substep), and B2
    (``pgs_solve_fused_f32``) at the ant's (25, 8, 14), the humanoid's
    compacted (32, 17, 23) and uncompacted (192, 17, 23) shapes on
    captured operands; CUDA events over 50 calls, W = 4096;
  - times B3 and B4 at the sand cell (N = 32768, res 64, the bases of
    chip_smoke.py's sand state, random values): B3 with its binning
    (``mpm_bin_particles`` then ``mpm_p2g_binned_f32``; a checkout without
    binning zero-fills the grid and runs ``mpm_p2g_f32``, as its wrapper
    did) and B4 given the bins (``mpm_g2p_f32`` without); this checkout's
    binning alone, B3 given bins and B4 with its binning too; the calls
    queued behind a spin kernel (chip_smoke.time_ms);
  - holds this checkout's outputs against the parent's, and counts the
    envs whose divergence-guard halvings differ at (1, 0, 3), where the
    guard acts on rounding noise;
  - profiles 20 calls each of this checkout's B3 (with its binning) and
    B4 (given bins): mean device time per call of each kernel they launch;
  - profiles 5 sand steps on this checkout's kernel path with
    torch.profiler: device time per step, the share of
    ``torch.linalg.svd`` and of the transfer kernels;
  - profiles one frame (4 substeps) of the humanoid and of the ant on the
    kernel path with torch.profiler: device time and device operations,
    and times env-steps/s of each kernel path over 10 frames, in the same
    turns (skipped with ``--mpm-only``; only this checkout's when the
    parent's B2 entry takes another argument list, as one from before
    the w_other operand does).
With ``--worlds`` (this checkout only) it profiles one frame of each of
chip_smoke.py's replicated scenes, cartpole x 8192 and humanoid x 8192
through ``replicate`` + ``step`` after their warm-up: device time, device
operations, the frame's wall time (host clock around a synchronized frame,
the mean of 10) and the device's busy share, device time over wall time.
With ``--planar`` (this checkout only) it profiles the same way one frame
of chip_smoke.py's planar paths: half_cheetah x 4096 (step_batched,
euler, after one warm-up frame) and hopper x 8192 (replicate + step, dt
0.002, after its warm-up) under RK4 and, for the host cost of the RK4
stages, under euler. With ``--hetero`` (this checkout only) it profiles
the same way one frame of chip_smoke.py's heterogeneous paths after a
warm-up frame: the rod x 4096 (ball joints, 8 substeps of 1/480 s) and the
randomized ant with a ball x 4096 (two groups, two-sided contacts, 4
substeps of 1/240 s). Writes one JSON object (to ``--out`` as well, when
given). Without a CUDA device it exits 2.
"""

import argparse
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def load_kernels(root, tag):
    """The ``_kernels`` module of the checkout at ``root``, loaded under a
    name of its own, with its library built."""
    path = os.path.join(root, "newton_tpu_torch", "_kernels.py")
    spec = importlib.util.spec_from_file_location(f"_kernels_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.lib()
    return mod


def capture(dev):
    """Operands of B1 and B2 at the main path's shapes: the ant pushed into
    the ground, the humanoid after 10 frames from reset, and the humanoid
    lying uncompacted. Returns {label: ("chol", (Mi, rhs)) or ("pgs",
    (args, kw))}."""
    import numpy as np
    import torch
    ops = {}
    rng = np.random.RandomState(1)
    A = rng.randn(cs.W, 14, 14).astype(np.float32)
    spd = A @ np.transpose(A, (0, 2, 1)) + 2.0 * np.eye(14, dtype=np.float32)
    ops["B1 d=14 random SPD"] = ("chol", (
        torch.as_tensor(spd, device=dev),
        torch.as_tensor(rng.randn(cs.W, 14).astype(np.float32), device=dev)))
    model, pipe, solver, state0 = cs.build_ant(dev)
    sb = cs.dropped_state(model, state0, dev)
    rec = {}
    ctrl = cs.ctrl_sampler(model, dev, seed=1)(cs.W)
    solver.step_batched(sb, None, cs.batched_control(model, ctrl),
                        pipe.collide(sb), cs.DT, kernels=False, record=rec)
    ops["B2 ant (25, 8, 14)"] = ("pgs", rec["pgs"])
    hmodel, hpipe, hsolver = cs.build_humanoid(dev)
    sample = cs.ctrl_sampler(hmodel, dev, seed=10)
    hs = cs.humanoid_reset(hmodel, dev, seed=11)
    hs = cs.run_frames(hmodel, hpipe, hsolver, hs, sample, cs.HUMANOID_WARMUP,
                       False)
    rec = {}
    hsolver.step_batched(hs, None, cs.batched_control(hmodel, sample(cs.W)),
                         hpipe.collide(hs), cs.DT, kernels=False, record=rec)
    ops["B1 d=23 humanoid"] = ("chol", rec["chol"])
    ops["B2 humanoid (32, 17, 23)"] = ("pgs", rec["pgs"])
    _, pipe_c, solver_c = cs.build_humanoid(dev, contact_cap=0)
    lying = cs.humanoid_reset(hmodel, dev, seed=13, lying_z=0.1)
    rec = {}
    solver_c.step_batched(lying, None, cs.batched_control(hmodel,
                                                          sample(cs.W)),
                          pipe_c.collide(lying), cs.DT, kernels=False,
                          record=rec)
    ops["B2 uncompacted (192, 17, 23)"] = ("pgs", rec["pgs"])
    return ops, (model, pipe, solver, state0), (hmodel, hpipe, hsolver)


def caller(lib, kind, operands):
    """A function that launches the kernel of ``lib`` on ``operands`` and
    returns its outputs."""
    import torch
    if kind == "chol":
        Mi, rhs = operands
        W, d, _ = Mi.shape
        Minv, x = torch.empty_like(Mi), torch.empty_like(rhs)

        # a library with the generic instances takes a scratch pointer
        # (None: the register instances that these shapes run need none)
        scratch = [None] * (len(lib.chol_inv_solve_f32.argtypes) - 7)

        def run():
            err = lib.chol_inv_solve_f32(
                Mi.data_ptr(), rhs.data_ptr(), Minv.data_ptr(), x.data_ptr(),
                W, d, *scratch, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"chol_inv_solve_f32: CUDA error {err}")
            return Minv, x
        return run
    args, kw = operands
    J, Minv, qd, b, act, mu, lam0 = args
    W, _, d = J.shape
    ld = kw["ld"]
    r = b.shape[1]
    lam = torch.empty((W, r), device=J.device)
    dqd = torch.empty((W, d), device=J.device)
    halv = torch.empty((W,), dtype=torch.int32, device=J.device)
    # a library with the w_other operand takes its pointer after ld (None:
    # these shapes are one-sided), one with the global-scratch instance a
    # scratch pointer
    n_args = len(lib.pgs_solve_fused_f32.argtypes)
    w_other = [None] if n_args >= 23 else []
    scratch = [None] * (n_args - 21 - len(w_other))

    def run():
        err = lib.pgs_solve_fused_f32(
            *[t.data_ptr() for t in (J, Minv, qd, b, act, mu, lam0, ld)],
            *w_other, *[t.data_ptr() for t in (lam, dqd, halv)],
            W, kw["c"], int(ld.numel()), d, int(kw["iters"]),
            float(kw["omega"]), int(bool(kw["use_cone"])),
            float(kw["diag_scale"]), float(kw["reg"]), *scratch,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"pgs_solve_fused_f32: CUDA error {err}")
        return lam, dqd, halv
    return run


def shape_of(kind, operands):
    if kind == "chol":
        return dict(d=operands[0].shape[1], W=operands[0].shape[0])
    args, kw = operands
    return dict(c=kw["c"], nl=int(kw["ld"].numel()), d=args[0].shape[2],
                W=args[0].shape[0])


def kernel_times(libs, ops):
    out = {}
    for label, (kind, operands) in ops.items():
        runs = {tag: caller(lib, kind, operands) for tag, lib in libs.items()}
        order = (["parent", "this", "this", "parent"] if "parent" in libs
                 else ["this", "this"])
        turns = {tag: [] for tag in libs}
        for tag in order:
            turns[tag].append(cs.time_ms(runs[tag]))
        t_ms, by = cs.bound_ms(*cs.kernel_cost(
            "chol_inv_solve" if kind == "chol" else "pgs_solve_fused",
            **shape_of(kind, operands)))
        row = dict(turns_ms=turns, bound_ms=t_ms, bound_by=by,
                   ms={tag: sum(v) / len(v) for tag, v in turns.items()})
        if "parent" in libs:
            a = [t.clone() for t in runs["this"]()]
            b = runs["parent"]()
            if kind == "chol":
                row["max_abs_diff"] = max(float((x - y).abs().max())
                                          for x, y in zip(a, b))
            else:
                same = a[2] == b[2]
                row["guard_mismatch_envs"] = int((~same).sum())
                row["max_abs_diff"] = max(
                    float((a[i][same] - b[i][same]).abs().max())
                    for i in (0, 1))
            row["speedup"] = row["ms"]["parent"] / row["ms"]["this"]
        out[label] = row
    return out


MPM_KINDS = ("p2g", "g2p", "p2g_given_bins", "bin", "g2p_with_binning")


def mpm_operands(dev):
    """The sand cell's transfer operands: bases and weights of the initial
    sand state of chip_smoke.py, random values (13 channels) and grid (12
    channels)."""
    import numpy as np
    import torch
    _, solver, state = cs.build_sand(dev)
    _, base, w, _ = solver.stencil(state.particle_q)
    rng = np.random.RandomState(5)
    vals = torch.as_tensor(rng.randn(cs.MPM_N, 13), dtype=torch.float32,
                           device=dev)
    grid = torch.as_tensor(rng.randn(cs.MPM_RES, cs.MPM_RES, cs.MPM_RES, 12),
                           dtype=torch.float32, device=dev)
    return base, w, vals, grid


def mpm_callers(lib, ops):
    """{kind: function} of the MPM kernels of ``lib`` (kinds MPM_KINDS, as
    far as the library has them); each returns its output."""
    import torch
    from newton_tpu_torch.solvers import mpm_transfer as mt
    base, w, vals, grid = ops
    n, res = base.shape[0], cs.MPM_RES
    G = torch.empty((res, res, res, 13), device=base.device)
    P = torch.empty((n, 12), device=base.device)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def check(err, name):
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
    if not hasattr(lib, "mpm_bin_particles"):
        def p2g():
            G.zero_()
            check(lib.mpm_p2g_f32(base.data_ptr(), w.data_ptr(),
                                  vals.data_ptr(), G.data_ptr(), n, 13, res,
                                  stream()), "mpm_p2g_f32")
            return G

        def g2p():
            check(lib.mpm_g2p_f32(base.data_ptr(), w.data_ptr(),
                                  grid.data_ptr(), P.data_ptr(), n, 12, res,
                                  stream()), "mpm_g2p_f32")
            return P
        return dict(p2g=p2g, g2p=g2p)
    K = mt.tiles(res)[1]
    meta = torch.empty((mt.meta_size(res),), dtype=torch.int32,
                       device=base.device)
    srt = torch.empty((n, 4), dtype=torch.int32, device=base.device)
    scratch = torch.empty((min(K, n) * (mt.TILE + 2) ** 3 * 13,),
                          device=base.device)

    def bins():
        check(lib.mpm_bin_particles(base.data_ptr(), meta.data_ptr(),
                                    srt.data_ptr(), n, res, stream()),
              "mpm_bin_particles")
        return meta

    def p2g_given_bins():
        check(lib.mpm_p2g_binned_f32(
            w.data_ptr(), vals.data_ptr(), meta.data_ptr(), srt.data_ptr(),
            scratch.data_ptr(), G.data_ptr(), n, 13, res, stream()),
            "mpm_p2g_binned_f32")
        return G

    def g2p():
        check(lib.mpm_g2p_binned_f32(
            w.data_ptr(), grid.data_ptr(), meta.data_ptr(), srt.data_ptr(),
            P.data_ptr(), n, 12, res, stream()), "mpm_g2p_binned_f32")
        return P
    bins()
    return dict(p2g=lambda: (bins(), p2g_given_bins())[1], g2p=g2p,
                p2g_given_bins=p2g_given_bins, bin=bins,
                g2p_with_binning=lambda: (bins(), g2p())[1])


def mpm_times(libs, ops):
    """Each MPM kind of MPM_KINDS: times in turns where both checkouts
    have it, bound and share of bound, and this checkout's outputs against
    the parent's."""
    runs = {tag: mpm_callers(lib, ops) for tag, lib in libs.items()}
    nodes = cs.active_nodes(ops[0], cs.MPM_RES)
    out = dict(active_nodes=nodes)
    for kind in MPM_KINDS:
        tags = [t for t in ("parent", "this") if kind in runs.get(t, {})]
        order = (["parent", "this", "this", "parent"] if len(tags) == 2
                 else ["this", "this"])
        turns = {tag: [] for tag in tags}
        for tag in order:
            turns[tag].append(cs.time_ms(runs[tag][kind], queued=True))
        ms = {tag: sum(v) / len(v) for tag, v in turns.items()}
        row = dict(turns_ms=turns, ms=ms)
        if kind in ("p2g", "p2g_given_bins"):
            shape = dict(N=cs.MPM_N, C=13, res=cs.MPM_RES)
            row.update(cs.bound_fields("mpm_p2g", ms["this"], **shape))
        elif kind in ("g2p", "g2p_with_binning"):
            shape = dict(N=cs.MPM_N, C=12, active_nodes=nodes)
            row.update(cs.bound_fields("mpm_g2p", ms["this"], **shape))
        if len(tags) == 2:
            a = runs["this"][kind]().clone()
            b = runs["parent"][kind]()
            row["max_abs_diff"] = float((a - b).abs().max())
            row["speedup"] = ms["parent"] / ms["this"]
        out[kind] = row
    return out


def mpm_kernel_profile(run, calls=20):
    """Mean device time (us) per call of each device kernel that ``run``
    (one of mpm_callers' functions) launches, from torch.profiler."""
    import collections
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    us = collections.defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].replace("void ", "")
            us[name] += e.time_range.elapsed_us() / calls
    return dict(us)


def sand_profile(dev, steps=5):
    """Device time per sand step on the kernel path (one profiled window of
    ``steps`` steps after 25 warm-up steps), the share of torch.linalg.svd
    and of the transfer and binning kernels, and device operations per
    step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    _, solver, state = cs.build_sand(dev)
    state = cs.run_mpm(solver, state, 25, True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state = cs.run_mpm(solver, state, steps, True)
    dev_ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev_ev:
        raise RuntimeError("torch.profiler traced no device operation")
    total = sum(e.time_range.elapsed_us() for e in dev_ev) / 1e3
    mpm = sum(e.time_range.elapsed_us() for e in dev_ev
              if "mpm_" in e.name) / 1e3

    def device_ms(e):
        t = getattr(e, "device_time_total", None)
        return (t if t is not None else e.cuda_time_total) / 1e3
    svd = max((device_ms(e) for e in prof.key_averages()
               if "linalg_svd" in e.key), default=0.0)
    return dict(steps=steps, device_ms_per_step=total / steps,
                svd_ms_per_step=svd / steps, svd_share=svd / total,
                transfer_ms_per_step=mpm / steps, transfer_share=mpm / total,
                device_ops_per_step=len(dev_ev) / steps)


def guard_noise(libs, dev):
    """Envs whose divergence-guard halvings differ, at the tiny shape
    (c, nl, d) = (1, 0, 3) on random operands: each kernel and the plain
    float32 version against the plain version run in float64."""
    from newton_tpu_torch.solvers.generalized import pgs
    args, ld = cs.random_pgs_inputs(dev, 1, 0, 3, seed=0)
    kw = dict(c=1, ld=ld, iters=cs.ITERS, omega=0.8, use_cone=False,
              diag_scale=1.0, reg=1e-3)
    h32 = pgs.pgs_solve_fused_plain(*args, **kw, return_halvings=True)[2]
    h64 = pgs.pgs_solve_fused_plain(*[a.double() for a in args], **kw,
                                    return_halvings=True)[2]
    out = dict(plain_f32_vs_f64=int((h32 != h64).sum()), envs=cs.W)
    for tag, lib in libs.items():
        h = caller(lib, "pgs", (args, kw))()[2]
        out[f"{tag}_vs_plain_f32"] = int((h != h32).sum())
        out[f"{tag}_vs_f64"] = int((h != h64).sum())
    return out


def frame_profile(run_frame):
    """Device time (ms) and device operations of one frame."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run_frame()                                   # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_frame()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        raise RuntimeError("torch.profiler traced no device operation")
    return dict(device_ms=sum(e.time_range.elapsed_us() for e in dev) / 1e3,
                device_ops=len(dev))


def worlds_profile(dev):
    """One profiled frame of cartpole x 8192 and humanoid x 8192 (replicate
    + step), each after its warm-up, and the mean wall time of a frame."""
    import torch
    out = {}
    for name, xml, iters, warm in (
            ("cartpole", "inverted_pendulum.xml", cs.CARTPOLE_ITERS, 1),
            ("humanoid", "humanoid.xml", cs.ITERS, cs.HUMANOID_WARMUP)):
        model, pipe, solver, _ = cs.build_replicated(dev, xml, cs.WORLDS,
                                                     iters)
        sample = cs.ctrl_sampler(model, dev, seed=20)
        box = {"s": cs.flat_reset(model, dev, seed=21)}
        box["s"] = cs.run_flat_frames(model, pipe, solver, box["s"], sample,
                                      warm, True)

        def run_frame(model=model, pipe=pipe, solver=solver, box=box,
                      sample=sample):
            box["s"] = cs.run_flat_frames(model, pipe, solver, box["s"],
                                          sample, 1, True)
        prof = frame_profile(run_frame)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(cs.FRAMES):
            run_frame()
        wall_ms = (time.perf_counter() - t0) / cs.FRAMES * 1e3
        out[name] = dict(prof, wall_ms=wall_ms,
                         busy_share=prof["device_ms"] / wall_ms,
                         worlds=cs.WORLDS, substeps=cs.SUBSTEPS)
    return out


def planar_profile(dev):
    """One profiled frame of half_cheetah x 4096 (euler) and of hopper x
    8192 under RK4 and under euler, each after its warm-up, and the mean
    wall time of a frame."""
    import torch
    import newton_tpu_torch as nt
    out = {}
    model, pipe, solver = cs.build_cheetah(dev)
    sample = cs.ctrl_sampler(model, dev, seed=40)
    box = {"s": nt.batch_state(nt.eval_fk(model, model.joint_q0,
                                          model.joint_qd0, model.state()),
                               cs.PLANAR_W)}

    def cheetah_frame():
        box["s"] = cs.run_frames(model, pipe, solver, box["s"], sample, 1,
                                 True)
    runs = [("half_cheetah euler", cheetah_frame, cs.PLANAR_W)]
    for integ in ("rk4", "euler"):
        hm, hp, hs, _ = cs.build_replicated(dev, "hopper.xml", cs.WORLDS,
                                            cs.ITERS, integrator=integ)
        hsample = cs.ctrl_sampler(hm, dev, seed=50)
        hbox = {"s": cs.run_flat_frames(
            hm, hp, hs, cs.flat_reset(hm, dev, seed=51,
                                      noise=cs.HOPPER_NOISE),
            hsample, cs.HOPPER_WARMUP, True, dt=cs.HOPPER_DT)}

        def hopper_frame(hm=hm, hp=hp, hs=hs, hbox=hbox, hsample=hsample):
            hbox["s"] = cs.run_flat_frames(hm, hp, hs, hbox["s"], hsample, 1,
                                           True, dt=cs.HOPPER_DT)
        runs.append((f"hopper {integ}", hopper_frame, cs.WORLDS))
    cheetah_frame()                               # warm-up frame
    for name, run_frame, n in runs:
        prof = frame_profile(run_frame)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(cs.FRAMES):
            run_frame()
        wall_ms = (time.perf_counter() - t0) / cs.FRAMES * 1e3
        out[name] = dict(prof, wall_ms=wall_ms,
                         busy_share=prof["device_ms"] / wall_ms, envs=n,
                         substeps=cs.SUBSTEPS,
                         env_steps_per_s=n * cs.SUBSTEPS / wall_ms * 1e3)
    return out


def hetero_profile(dev):
    """One profiled frame of the rod x 4096 and of the randomized ant with a
    ball x 4096 (flat ``step``), each after a warm-up frame, and the mean
    wall time of a frame."""
    import torch
    import newton_tpu_torch as nt
    out = {}
    b, _ = cs.rod_scene(nt, cs.HETERO_W)
    rm = b.finalize(dev)
    rs = nt.SolverFeatherstone(rm)
    rbox = {"s": nt.eval_fk(rm, rm.joint_q0, rm.joint_qd0, rm.state())}
    rctl = rm.control()

    def rod_frame():
        rbox["s"] = cs.run_steps(rs, rbox["s"], rctl, cs.ROD_SUBSTEPS,
                                 cs.ROD_DT, True)
    b, _ = cs.ant_ball_scene(nt, cs.HETERO_W,
                             os.path.join(nt.ASSET_DIR, "ant.xml"))
    am = b.finalize(dev)
    ap_ = nt.CollisionPipeline(am)
    as_ = nt.SolverMuJoCo(am, iterations=cs.ITERS, integrator="euler")
    cs.randomize_ant_ball(am, 60)
    as_.notify_model_changed()
    sample = cs.ctrl_sampler(am, dev, seed=61)
    abox = {"s": nt.eval_fk(am, am.joint_q0, am.joint_qd0, am.state())}
    actl = am.control()

    def ant_frame():
        abox["s"] = cs.run_steps(as_, abox["s"], actl, cs.SUBSTEPS, cs.DT,
                                 True, pipe=ap_, sample=sample)
    for name, run_frame, substeps in (("rod", rod_frame, cs.ROD_SUBSTEPS),
                                      ("ant with a ball", ant_frame,
                                       cs.SUBSTEPS)):
        run_frame()                               # warm-up frame
        prof = frame_profile(run_frame)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(cs.FRAMES):
            run_frame()
        wall_ms = (time.perf_counter() - t0) / cs.FRAMES * 1e3
        out[name] = dict(prof, wall_ms=wall_ms,
                         busy_share=prof["device_ms"] / wall_ms,
                         worlds=cs.HETERO_W, substeps=substeps,
                         env_steps_per_s=cs.HETERO_W * substeps / wall_ms
                         * 1e3)
    return out


def main():
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="root of the checkout to compare with")
    ap.add_argument("--out", help="also write the JSON object here")
    ap.add_argument("--mpm-only", action="store_true",
                    help="only the MPM kernels and the sand profile")
    ap.add_argument("--worlds", action="store_true",
                    help="only the profiles of the replicated scenes")
    ap.add_argument("--planar", action="store_true",
                    help="only the profiles of the planar robots' paths")
    ap.add_argument("--hetero", action="store_true",
                    help="only the profiles of the rod and the ant with a "
                         "ball")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    if a.worlds:
        return emit(dict(card=cs.card_line(), worlds=worlds_profile(dev)),
                    a.out)
    if a.planar:
        return emit(dict(card=cs.card_line(), planar=planar_profile(dev)),
                    a.out)
    if a.hetero:
        return emit(dict(card=cs.card_line(), hetero=hetero_profile(dev)),
                    a.out)
    from newton_tpu_torch import _kernels
    libs = {"this": _kernels.lib()}
    if a.parent:
        libs["parent"] = load_kernels(os.path.abspath(a.parent),
                                      "parent").lib()
    mpm_ops = mpm_operands(dev)
    runs = mpm_callers(libs["this"], mpm_ops)
    res = dict(card=cs.card_line(), mpm=mpm_times(libs, mpm_ops),
               mpm_kernels_us={kind: mpm_kernel_profile(runs[kind])
                               for kind in ("p2g", "g2p")},
               sand_profile=sand_profile(dev))
    if a.mpm_only:
        return emit(res, a.out)
    ops, ant, hum = capture(dev)
    res.update(kernels=kernel_times(libs, ops),
               guard_noise=guard_noise(libs, dev))

    def use(tag):
        _kernels._lib = libs[tag]

    # the frames run the port's wrappers on each library: a parent whose B2
    # entry takes another argument list (one without w_other) runs none
    sig = {tag: len(lib.pgs_solve_fused_f32.argtypes)
           for tag, lib in libs.items()}
    frame_tags = [t for t in ("parent", "this", "this", "parent")
                  if t in libs and sig[t] == sig["this"]]
    frames = {}
    for name, (model, pipe, solver, state) in (
            ("humanoid", (*hum, cs.humanoid_reset(hum[0], dev, seed=11))),
            ("ant", (*ant[:3], cs.dropped_state(ant[0], ant[3], dev,
                                                drop=0.0)))):
        sample = cs.ctrl_sampler(model, dev, seed=20)
        box = {"s": state}

        def run_frame(model=model, pipe=pipe, solver=solver, box=box,
                      sample=sample):
            box["s"] = cs.run_frames(model, pipe, solver, box["s"], sample,
                                     1, True)
        prof = {tag: [] for tag in set(frame_tags)}
        rate = {tag: [] for tag in set(frame_tags)}
        for tag in frame_tags:
            use(tag)
            prof[tag].append(frame_profile(run_frame))
            t0 = time.perf_counter()
            box["s"] = cs.run_frames(model, pipe, solver, box["s"], sample,
                                     cs.FRAMES, True)
            rate[tag].append(cs.FRAMES * cs.SUBSTEPS * cs.W
                             / (time.perf_counter() - t0))
        frames[name] = dict(profile=prof, env_steps_per_s=rate)
    use("this")
    res["frames"] = frames
    return emit(res, a.out)


def emit(res, path):
    line = json.dumps(res)
    print(line)
    if path:
        with open(path, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
