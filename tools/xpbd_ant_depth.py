#!/usr/bin/env python3
"""How deep the ant's torso sinks under SolverXPBD with random direct ctrl,
in the JAX package and in the port, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/xpbd_ant_depth.py [--worlds 256]
        [--frames 30] [--out FILE]

Steps ``replicate(ant, worlds)`` under ``SolverXPBD(iterations=8)`` (dt
1/240, 4 substeps per frame) in both packages with the same ctrl each
frame (``chip_smoke.ant_xpbd_ctrl``: joint_f = ctrl x mjc:actuator_gear,
ctrl uniform in the clipped ctrl range, from a seeded torch generator),
as ``bench.py --solver xpbd`` and ``chip_smoke.py`` phase 21 drive it,
and prints one JSON object: for each package the smallest root z
(the torso centre; the torso is a sphere of radius 0.25) over the worlds
at the end of every frame, and the worlds whose root z ever fell below
0.1. The two runs agree for ~10 frames and then part (the gaits are
chaotic), so the packages are compared by their distributions.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--worlds", type=int, default=256)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--out")
    args = ap.parse_args()
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    import chip_smoke as cs
    import newton_tpu as jt
    import newton_tpu_torch as nt
    from newton_tpu.sim.articulation import eval_fk as j_eval_fk
    from newton_tpu.sim.collide import CollisionPipeline as JPipe
    from newton_tpu.solvers import SolverXPBD as JX

    n, ant = args.worlds, os.path.join(nt.ASSET_DIR, "ant.xml")

    def scene(lib):
        r = lib.ModelBuilder()
        r.add_mjcf(ant)
        b = lib.ModelBuilder()
        b.replicate(r, n)
        return b
    tm = scene(nt).finalize("cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    ctrls = [cs.ant_xpbd_ctrl(tm, gen) for _ in range(args.frames)]

    jm = scene(jt).finalize()
    jsol, jpipe = JX(jm, iterations=8), JPipe(jm)

    @jax.jit
    def frame(s, f):
        c = jm.control().replace(joint_f=f)

        def sub(s, _):
            return jsol.step(s, None, c, jpipe.collide(s), cs.DT), None
        return jax.lax.scan(sub, s, None, length=cs.SUBSTEPS)[0]

    tsol, tpipe = nt.SolverXPBD(tm, iterations=8), nt.CollisionPipeline(tm)
    js = j_eval_fk(jm, jm.joint_q0, jm.joint_qd0, jm.state())
    ts = nt.eval_fk(tm, tm.joint_q0, tm.joint_qd0, tm.state())
    tc = tm.control()
    out = {"worlds": n, "frames": args.frames}
    for name in ("jax", "port"):
        out[name] = {"root_z_min_per_frame": [], "worlds_below_0.1": []}
    below = {"jax": np.zeros(n, bool), "port": np.zeros(n, bool)}
    for f in range(args.frames):
        js = frame(js, jnp.asarray(ctrls[f].numpy()))
        tc.joint_f = ctrls[f]
        for _ in range(cs.SUBSTEPS):
            ts = tsol.step(ts, None, tc, tpipe.collide(ts), cs.DT)
        for name, q in (("jax", np.asarray(js.joint_q)),
                        ("port", ts.joint_q.numpy())):
            z = q.reshape(n, -1)[:, 2]
            out[name]["root_z_min_per_frame"].append(float(z.min()))
            below[name] |= z < 0.1
    for name in below:
        out[name]["worlds_below_0.1"] = np.nonzero(below[name])[0].tolist()
    text = json.dumps(out)
    print(text)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")


if __name__ == "__main__":
    main()
