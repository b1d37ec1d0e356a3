#!/usr/bin/env python3
"""K1 (closest-hit ray casts) and K4 (B2's backward) on the card: times,
B2's output digests, and chip_smoke.py's phases 56-58 alone.

    python3 scripts/torch_k1_k4.py                  # this tree's times
    python3 scripts/torch_k1_k4.py --parent _proof/parent   # A/B turns
    python3 scripts/torch_k1_k4.py --golden [--parent DIR]  # B2 digests
    python3 scripts/torch_k1_k4.py --phases         # phases 56-58

Times: K1 at the camera ant x 1024's start pose (R = 4,194,304 rays, S =
14,336 shapes; its pre-pass included, timed queued and back to back) and
the render; K4 at the ant's (25, 8, 14) and the humanoid's (32, 17, 23), W
= 4096, 0, 8 and 16 sweeps (the differences are the sweeps' share), from
B2's saved forward where the tree has one; B2 with and without the save.
CUDA events with the stream held busy (chip_smoke.time_ms, queued). With
``--parent`` (another checkout, e.g. ``git archive <commit>`` unpacked in
the gitignored ``_proof/``) the two trees run in turns parent, this,
this, parent, each in its own process. ``--golden`` prints the sha256
digests of B2's outputs on tests/test_torch_kernels.py's golden cases.
Prints one JSON line per run; exits 2 without CUDA.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _times(res):
    import inspect
    import numpy as np
    import torch
    import newton_tpu_torch as nt
    import chip_smoke as cs
    import test_torch_kernels as tk
    from newton_tpu_torch.geometry import raycast
    from newton_tpu_torch.sensors import SensorTiledCamera
    from newton_tpu_torch.solvers.generalized import pgs
    m = cs.camera_ant_scene(nt, cs.CAM_W).finalize("cuda")
    s = nt.eval_fk(m, m.joint_q0, m.joint_qd0, m.state())
    X = raycast.shape_world_transforms(m, s)
    cls = torch.as_tensor(raycast.shape_classes(m), device="cuda")
    cam = SensorTiledCamera(m, width=cs.CAM_RES, height=cs.CAM_RES,
                            fov_y=cs.CAM_FOV)
    torso = np.nonzero(np.asarray(m.structure.body_key) == "torso")[0]
    poses = torch.cat([s.body_q[torso, :3] + torch.tensor(
        cs.CAM_OFFSET, device="cuda"), torch.tensor(
        cs.CAM_QUAT, device="cuda").expand(cs.CAM_W, 4)], 1)
    o, d = cam.rays(poses)
    res["k1_ms"] = cs.time_ms(lambda: raycast.closest_analytic(
        o, d, X, m.shape_scale, cls, 100.0), n=3, queued=True)
    res["k1_ms_unqueued"] = cs.time_ms(lambda: raycast.closest_analytic(
        o, d, X, m.shape_scale, cls, 100.0), n=3)
    res["render_ms"] = cs.time_ms(lambda: cam.render(s, poses), n=3)
    k = raycast.closest_analytic(o, d, X, m.shape_scale, cls, 100.0)
    res["k1_digest"] = tk._b2_digest(k)
    if "stats" in inspect.signature(raycast.closest_analytic).parameters:
        res["k1_work"] = {}
        raycast.closest_analytic(o, d, X, m.shape_scale, cls, 100.0,
                                 stats=res["k1_work"])
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


def _golden(res):
    import torch
    import test_torch_kernels as tk
    from newton_tpu_torch.solvers.generalized import pgs
    for case in tk._B2_GOLDEN_CASES:
        ops, kw = tk._b2_golden_inputs(case)
        with torch.no_grad():
            res[case] = tk._b2_digest(pgs.pgs_solve_fused(*ops, **kw))


def _phases(res):
    import time
    import torch
    import chip_smoke as cs
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


def run_one(pkg, mode):
    """Runs in a process of its own: pkg's newton_tpu_torch first on the
    path, this tree's chip_smoke.py and tests beside it."""
    sys.path.insert(0, pkg)
    sys.path.insert(1, ROOT)
    sys.path.insert(2, os.path.join(ROOT, "tests"))
    import torch
    import newton_tpu_torch
    import chip_smoke as cs
    res = {"package": os.path.dirname(newton_tpu_torch.__file__),
           "mode": mode, "card": cs.card_line(),
           "device": torch.cuda.get_device_name(0)}
    {"times": _times, "golden": _golden, "phases": _phases}[mode](res)
    print(json.dumps(res, default=str), flush=True)


def spawn(pkg, mode):
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--one", pkg, mode], capture_output=True,
                         text=True)
    sys.stdout.write(out.stdout)
    if out.returncode:
        sys.stderr.write(out.stderr[-4000:])
        raise SystemExit(out.returncode)


def main(argv):
    if "--one" in argv:
        k = argv.index("--one")
        run_one(argv[k + 1], argv[k + 2])
        return 0
    import torch
    if not torch.cuda.is_available():
        print("torch_k1_k4: no CUDA device", file=sys.stderr)
        return 2
    parent = None
    if "--parent" in argv:
        parent = os.path.abspath(argv[argv.index("--parent") + 1])
    if "--phases" in argv:
        spawn(ROOT, "phases")
        return 0
    mode = "golden" if "--golden" in argv else "times"
    for p in [ROOT] if parent is None else [parent, ROOT, ROOT, parent]:
        spawn(p, mode)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
