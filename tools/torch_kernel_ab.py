#!/usr/bin/env python3
"""Kernels of two checkouts of the PyTorch port, side by side on one CUDA
card.

    python3 tools/torch_kernel_ab.py [--parent DIR] [--mpm-only] [--out FILE]
    python3 tools/torch_kernel_ab.py --worlds [--out FILE]
    python3 tools/torch_kernel_ab.py --planar [--out FILE]
    python3 tools/torch_kernel_ab.py --hetero [--out FILE]
    python3 tools/torch_kernel_ab.py --hand [--parent DIR]
    python3 tools/torch_kernel_ab.py --hand --golden [--parent DIR]
    python3 tools/torch_kernel_ab.py --hand --phases
    python3 tools/torch_kernel_ab.py --k2-variants [--out FILE]

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
given).

With ``--hand`` it times the hand-written kernels without a Pallas
counterpart, K1-K4, each checkout in a process of its own importing its
own package, in turns (parent, this, this, parent; this alone without
``--parent``), on operands both make from the same seeds:
  - K1 at the camera ant x 1024's start pose (R = 4,194,304 rays, S =
    14,336 shapes; its pre-pass included, queued and back to back) and
    the render, with the sha256 of (t, shape, normal);
  - K2 at chip_smoke.py phase 57 (a)'s shape (the 32,258-triangle terrain
    under the same cameras, R = 4,194,304) and on its 65,536 plain rays,
    with the sha256 of (t, normal);
  - K3 at phase 58's cases (``chol_inv_solve`` d = 14 and 23, W = 4096;
    ``chol_solve`` d = 6, W = 8192) on phase 58's operands, with its
    largest error against autograd of the plain version;
  - K4 at the ant's (25, 8, 14) and the humanoid's (32, 17, 23), W =
    4096, 0, 8 and 16 sweeps (the differences are the sweeps' share), from
    B2's saved forward where the checkout has one; B2 with and without
    the save.
CUDA events with the stream held busy (chip_smoke.time_ms, queued). With
``--golden`` it prints the sha256 digests of B2's outputs on
tests/test_torch_kernels.py's golden cases instead; with ``--phases``
chip_smoke.py's phases 56-58 alone. One JSON line a run.

With ``--k2-variants`` (this checkout only) it builds
``tools/k2_variants.cu`` (K2's walk with the BVH's top levels in shared
memory, with other block sizes and launch bounds, and a walk by warp vote;
none of them ships) and times K2 and each variant in turns (K2, the
variants, then the same backwards) at ``--hand``'s K2 operands, with
whether each gives K2's (t, normal) bit for bit and each one's registers,
blocks per SM and ptxas lines.
Without a CUDA device it exits 2.
"""

import argparse
import importlib.util
import json
import os
import subprocess
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
    # scratch pointer, one with the non-symmetric form its flag (0: the
    # symmetric form these operands have)
    n_args = len(lib.pgs_solve_fused_f32.argtypes)
    w_other = [None] if n_args >= 23 else []
    scratch = [None] * (n_args >= 22) + [0] * (n_args >= 24)

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
    if "--hand-one" in sys.argv:
        k = sys.argv.index("--hand-one")
        hand_one(sys.argv[k + 1], sys.argv[k + 2])
        return 0
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
    ap.add_argument("--hand", action="store_true",
                    help="K1-K4's times in turns, a process a checkout")
    ap.add_argument("--golden", action="store_true",
                    help="with --hand: B2's output digests")
    ap.add_argument("--phases", action="store_true",
                    help="with --hand: chip_smoke.py's phases 56-58 alone")
    ap.add_argument("--k2-variants", action="store_true",
                    help="K2 beside the variants of tools/k2_variants.cu")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    if a.hand:
        return hand(a)
    dev = torch.device("cuda", 0)
    if a.k2_variants:
        return emit(k2_variants(dev), a.out)
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


def digest(*ts):
    """The first 16 hex digits of the sha256 of the tensors' bytes."""
    import hashlib
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def camera_start(nt):
    """The camera ant x CAM_W at its start pose: (model, state, track
    camera, camera poses)."""
    import numpy as np
    import torch
    from newton_tpu_torch.sensors import SensorTiledCamera
    m = cs.camera_ant_scene(nt, cs.CAM_W).finalize("cuda")
    s = nt.eval_fk(m, m.joint_q0, m.joint_qd0, m.state())
    cam = SensorTiledCamera(m, width=cs.CAM_RES, height=cs.CAM_RES,
                            fov_y=cs.CAM_FOV)
    torso = np.nonzero(np.asarray(m.structure.body_key) == "torso")[0]
    poses = torch.cat([s.body_q[torso, :3] + torch.tensor(
        cs.CAM_OFFSET, device="cuda"), torch.tensor(
        cs.CAM_QUAT, device="cuda").expand(cs.CAM_W, 4)], 1)
    return m, s, cam, poses


def k2_scene(nt, state, poses, dev):
    """Phase 57 (a)'s K2 operands (chip_smoke.terrain_view and
    k2_operands) with the camera ant's bodies at ``state`` and its cameras
    at ``poses``: (pool, bvh_of, X, scale, o, d, the plain rays' o, d)."""
    m = cs.camera_extras_scene(nt, cs.CAM_W).finalize(dev)
    st, cam = cs.terrain_view(m, state.body_q)
    o, d = cam.rays(poses)
    pool, bvh_of, X, sc, op, dp = cs.k2_operands(m, st, o, d, dev)
    return pool, bvh_of, X, sc, o, d, op, dp


def hand_times(res):
    """K1-K4's times on this process's package (see the module
    docstring)."""
    import inspect
    import numpy as np
    import torch
    import newton_tpu_torch as nt
    import test_torch_kernels as tk
    from newton_tpu_torch.geometry import bvh, raycast
    from newton_tpu_torch.solvers.generalized import linalg, pgs
    dev = torch.device("cuda")
    m, s, cam, poses = camera_start(nt)
    X = raycast.shape_world_transforms(m, s)
    cls = torch.as_tensor(raycast.shape_classes(m), device="cuda")
    o, d = cam.rays(poses)
    res["k1_ms"] = cs.time_ms(lambda: raycast.closest_analytic(
        o, d, X, m.shape_scale, cls, 100.0), n=3, queued=True)
    res["k1_ms_unqueued"] = cs.time_ms(lambda: raycast.closest_analytic(
        o, d, X, m.shape_scale, cls, 100.0), n=3)
    res["render_ms"] = cs.time_ms(lambda: cam.render(s, poses), n=3)
    res["k1_digest"] = digest(*raycast.closest_analytic(
        o, d, X, m.shape_scale, cls, 100.0))
    res["k1_work"] = {}
    raycast.closest_analytic(o, d, X, m.shape_scale, cls, 100.0,
                             stats=res["k1_work"])
    # K2: phase 57 (a)'s terrain under the same cameras
    pool, bvh_of, Xm, scm, o2, d2, op, dp = k2_scene(nt, s, poses, dev)
    res["k2_ms"] = cs.time_ms(lambda: bvh.mesh_closest(
        pool, o2, d2, bvh_of, Xm, scm), n=10, queued=True)
    res["k2_ms_on_plain_rays"] = cs.time_ms(lambda: bvh.mesh_closest(
        pool, op, dp, bvh_of, Xm, scm), n=20, queued=True)
    res["k2_digest"] = digest(*bvh.mesh_closest(pool, o2, d2, bvh_of, Xm,
                                                scm))
    res["k2_work"] = {}
    bvh.mesh_closest(pool, o2, d2, bvh_of, Xm, scm, stats=res["k2_work"])
    # K3 on phase 58's operands
    for which, dd, n in cs.K3_SHAPES:
        Mi, rhs, gx, gM = cs.k3_operands(dev, dd, n)
        inv = which == "chol_inv_solve"
        if inv:
            Minv, x = linalg.chol_inv_solve(Mi, rhs)
            args = (Minv, x, gx, gM)
        else:
            x = linalg.chol_solve(Mi, rhs)
            args = (None, x, None, None, linalg.chol_solve(Mi, gx))
        label = f"k3_{which}_d{dd}"
        res[f"{label}_ms"] = cs.time_ms(lambda: linalg.chol_backward(*args),
                                        queued=True)
        gk = linalg.chol_backward(*args)
        M_ = Mi.detach().requires_grad_(True)
        r_ = rhs.detach().requires_grad_(True)
        if inv:
            gp = torch.autograd.grad(linalg.chol_inv_solve_plain(M_, r_),
                                     (M_, r_), (gM, gx))
        else:
            gp = torch.autograd.grad(linalg.chol_solve_plain(M_, r_),
                                     (M_, r_), gx)
        res[f"{label}_max_abs_err"] = max(float((a - b).abs().max())
                                          for a, b in zip(gk, gp))
    # K4 at 0, 8 and 16 sweeps; B2 with and without the save
    saves = "save" in inspect.signature(pgs.pgs_backward).parameters
    for label, (c, nl, dd) in (("ant", (25, 8, 14)),
                               ("humanoid", (32, 17, 23))):
        W = 4096
        ops = [torch.as_tensor(a, device="cuda")
               for a in tk._pgs_inputs(900 + nl, c, nl, dd, W)]
        ld = torch.arange(dd - nl, dd, dtype=torch.int32, device="cuda")
        rng = np.random.RandomState(3)
        glam = torch.as_tensor(rng.randn(W, 3 * c + 2 * nl)
                               .astype(np.float32), device="cuda")
        gdqd = torch.as_tensor(rng.randn(W, dd).astype(np.float32),
                               device="cuda")
        for iters in (0, 8, 16):
            kw = dict(c=c, iters=iters, omega=0.8, use_cone=False,
                      diag_scale=1.0, reg=1e-3, symmetric=True)
            extra = []
            if saves:
                save = torch.empty((W, pgs.save_floats(c, nl, dd, iters)),
                                   device="cuda")
                pgs._launch(*ops, ld, None, save=save, **kw)
                extra = [save]
            res[f"k4_{label}_T{iters}_ms"] = cs.time_ms(
                lambda: pgs.pgs_backward(*ops, ld, None, glam, gdqd,
                                         *extra, **kw), queued=True)
            if iters == 8:
                res[f"b2_{label}_ms"] = cs.time_ms(
                    lambda: pgs._launch(*ops, ld, None, **kw), queued=True)
                if saves:
                    res[f"b2_save_{label}_ms"] = cs.time_ms(
                        lambda: pgs._launch(*ops, ld, None, save=extra[0],
                                            **kw), queued=True)


def k2_variants(dev):
    """``--k2-variants`` (see the module docstring)."""
    import ctypes
    import shutil
    import tempfile
    import torch
    import newton_tpu_torch as nt
    from newton_tpu_torch import _kernels
    from newton_tpu_torch.geometry import bvh
    work = tempfile.mkdtemp()
    try:
        so = os.path.join(work, "k2_variants.so")
        out = subprocess.run([_kernels._nvcc(), *_kernels._FLAGS, "-shared",
                              "-o", so, os.path.join(HERE, "k2_variants.cu")],
                             capture_output=True, text=True)
        if out.returncode:
            raise RuntimeError(f"nvcc failed:\n{out.stderr}")
        vlib = ctypes.CDLL(so)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    P, I = ctypes.c_void_p, ctypes.c_int
    vlib.k2_variant_f32.argtypes = [I, P, P, I, P, P, P, I, P, P, P, P, I, P,
                                    P, P]
    vlib.k2_variant_info.argtypes = [I, P, P]
    vlib.k2_variant_name.argtypes = [I]
    vlib.k2_variant_name.restype = ctypes.c_char_p
    names = [vlib.k2_variant_name(v).decode()
             for v in range(vlib.k2_variant_count())]
    _, s, _, poses = camera_start(nt)
    pool, bvh_of, X, sc, o, d, _, _ = k2_scene(nt, s, poses, dev)
    o, d, b32 = o.contiguous(), d.contiguous(), bvh_of.to(torch.int32)
    M, R = b32.shape[0], o.shape[0]
    t = torch.empty((M, R), device=dev)
    n = torch.empty((M, R, 3), device=dev)

    def variant(v):
        _kernels.check(vlib.k2_variant_f32(
            v, o.data_ptr(), d.data_ptr(), R, X.data_ptr(), sc.data_ptr(),
            b32.data_ptr(), M, pool.boxes.data_ptr(), pool.slots.data_ptr(),
            pool.counts.data_ptr(), pool.params.data_ptr(), pool.leaf_budget,
            t.data_ptr(), n.data_ptr(),
            torch.cuda.current_stream().cuda_stream), names[v])

    def k2():
        return bvh.mesh_closest(pool, o, d, bvh_of, X, sc)
    ref_t, ref_n = k2()
    res = dict(card=cs.card_line(), rays=R, mesh_shapes=M,
               k2_info=cs.k2_info(),
               k2_ptxas=cs.ptxas_lines("raycast_mesh_kernel"),
               variants={}, ms={"K2": []})
    for v, name in enumerate(names):
        variant(v)
        regs, blocks = ctypes.c_int(0), ctypes.c_int(0)
        _kernels.check(vlib.k2_variant_info(v, ctypes.addressof(regs),
                                            ctypes.addressof(blocks)), name)
        res["variants"][name] = dict(
            bit_equal=bool(torch.equal(t, ref_t) and torch.equal(n, ref_n)),
            registers=regs.value, blocks_per_sm=blocks.value)
        res["ms"][name] = []
    res["variants_ptxas"] = {
        **cs.ptxas_lines("k2_lane", out.stderr),
        **cs.ptxas_lines("k2_vote", out.stderr)}
    turns = [None, *range(len(names))]
    for v in turns + turns[::-1]:
        fn = k2 if v is None else (lambda v=v: variant(v))
        res["ms"]["K2" if v is None else names[v]].append(
            cs.time_ms(fn, n=10, queued=True))
    return res


def b2_golden(res):
    """sha256 of B2's outputs on tests/test_torch_kernels.py's golden
    cases."""
    import torch
    import test_torch_kernels as tk
    from newton_tpu_torch.solvers.generalized import pgs
    for case in tk._B2_GOLDEN_CASES:
        ops, kw = tk._b2_golden_inputs(case)
        with torch.no_grad():
            res[case] = tk._b2_digest(pgs.pgs_solve_fused(*ops, **kw))


def hand_phases(res):
    """chip_smoke.py's phases 56-58 alone, with their kernels-line
    entries."""
    import torch
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cam, main_cam = cs.phase_camera_ant(dev)
    cam.pop("profile", None)
    paths = cs.phase_camera_paths(dev, main_cam)
    del main_cam
    grad, (_, _, _, rec) = cs.phase_grad_ant(dev)
    gk = cs.phase_grad_kernels(dev, rec)
    res.update(seconds=time.perf_counter() - t0, camera_ant=cam,
               camera_paths=paths, grad_ant=grad, grad_kernels=gk,
               kernels=cs.camera_kernel_entries(cam, paths)
               + cs.grad_kernel_entries(grad, gk))


def hand_one(pkg, mode):
    """One ``--hand`` run in a process of its own: pkg's newton_tpu_torch
    first on the path, this checkout's chip_smoke.py and tests beside
    it."""
    sys.path.insert(0, pkg)
    sys.path.insert(2, os.path.join(ROOT, "tests"))
    import torch
    import newton_tpu_torch
    res = {"package": os.path.dirname(newton_tpu_torch.__file__),
           "mode": mode, "card": cs.card_line(),
           "device": torch.cuda.get_device_name(0)}
    {"times": hand_times, "golden": b2_golden, "phases": hand_phases}[mode](
        res)
    print(json.dumps(res, default=str), flush=True)


def hand(a):
    """``--hand``: the runs in turns, each in a process of its own."""
    mode = "phases" if a.phases else "golden" if a.golden else "times"
    trees = [ROOT] if a.parent is None or mode == "phases" else [
        os.path.abspath(a.parent), ROOT, ROOT, os.path.abspath(a.parent)]
    for tree in trees:
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--hand-one", tree, mode],
                             capture_output=True, text=True)
        sys.stdout.write(out.stdout)
        if out.returncode:
            sys.stderr.write(out.stderr[-4000:])
            return out.returncode
    return 0


def emit(res, path):
    line = json.dumps(res)
    print(line)
    if path:
        with open(path, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
