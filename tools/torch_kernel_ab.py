#!/usr/bin/env python3
"""Kernels B1/B2 of two checkouts of the PyTorch port, side by side on one
CUDA card.

    python3 tools/torch_kernel_ab.py [--parent DIR] [--out FILE]

Builds this checkout's kernel library and, with ``--parent``, the library
of the checkout at DIR (its own ``newton_tpu_torch/csrc``), then on the same
operands, in turns (parent, this, this, parent):
  - times B1 (``chol_inv_solve_f32``) at d = 14 (random SPD) and d = 23
    (operands captured from a humanoid substep), and B2
    (``pgs_solve_fused_f32``) at the ant's (25, 8, 14), the humanoid's
    compacted (32, 17, 23) and uncompacted (192, 17, 23) shapes on
    captured operands; CUDA events over 50 calls, W = 4096;
  - holds this checkout's outputs against the parent's, and counts the
    envs whose divergence-guard halvings differ at (1, 0, 3), where the
    guard acts on rounding noise;
  - profiles one frame (4 substeps) of the humanoid and of the ant on the
    kernel path with torch.profiler: device time and device operations;
  - times env-steps/s of each kernel path over 10 frames, in the same
    turns.
Writes one JSON object (to ``--out`` as well, when given). Without a CUDA
device it exits 2.
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

        def run():
            err = lib.chol_inv_solve_f32(
                Mi.data_ptr(), rhs.data_ptr(), Minv.data_ptr(), x.data_ptr(),
                W, d, torch.cuda.current_stream().cuda_stream)
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

    def run():
        err = lib.pgs_solve_fused_f32(
            *[t.data_ptr() for t in (J, Minv, qd, b, act, mu, lam0, ld, lam,
                                     dqd, halv)],
            W, kw["c"], int(ld.numel()), d, int(kw["iters"]),
            float(kw["omega"]), int(bool(kw["use_cone"])),
            float(kw["diag_scale"]), float(kw["reg"]),
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


def main():
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="root of the checkout to compare with")
    ap.add_argument("--out", help="also write the JSON object here")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    from newton_tpu_torch import _kernels
    libs = {"this": _kernels.lib()}
    if a.parent:
        libs["parent"] = load_kernels(os.path.abspath(a.parent),
                                      "parent").lib()
    ops, ant, hum = capture(dev)
    res = dict(card=cs.card_line(), kernels=kernel_times(libs, ops),
               guard_noise=guard_noise(libs, dev))

    def use(tag):
        _kernels._lib = libs[tag]

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
        order = (["parent", "this", "this", "parent"] if a.parent
                 else ["this", "this"])
        prof = {tag: [] for tag in libs}
        rate = {tag: [] for tag in libs}
        for tag in order:
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
    line = json.dumps(res)
    print(line)
    if a.out:
        with open(a.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
