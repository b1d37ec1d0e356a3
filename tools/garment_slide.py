#!/usr/bin/env python3
"""Whether example_cloth_style3d.py's garment stays on its torso, in the
JAX package and in the port, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/garment_slide.py [--frames 80]

Steps ``chip_smoke.garment_scene`` (two sewn panels on a static capsule
torso over a ground plane) under ``SolverStyle3D(iterations=6,
contact_ke=2e4)`` with the collision pipeline's soft contacts, dt 1/480, 8
substeps per frame, in both packages, and prints one JSON object: every
5th frame, each package's largest particle z, its mean seam gap and its
active soft contacts, and the largest vertex difference between the two.
The two part once the contacts begin (the contact set flips), so they are
compared by these figures.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=80)
    args = ap.parse_args()
    import jax
    import numpy as np
    import chip_smoke as cs
    import newton_tpu as jt
    import newton_tpu_torch as nt
    from newton_tpu.sim.collide import CollisionPipeline as JPipe
    from newton_tpu.solvers import SolverStyle3D as JStyle3D
    dt, n = cs.GARMENT_DT, cs.GARMENT_SUBSTEPS

    b, (sa, sb) = cs.garment_scene(jt)
    jm = b.finalize()
    jp = JPipe(jm)
    jsolver = JStyle3D(jm, iterations=6, contact_ke=2.0e4)

    @jax.jit
    def frame(s):
        def sub(s, _):
            return jsolver.step(s, None, None, jp.collide(s), dt), None
        return jax.lax.scan(sub, s, None, length=n)[0]
    tm = cs.garment_scene(nt)[0].finalize("cpu")
    tp = nt.CollisionPipeline(tm)
    tsolver = nt.SolverStyle3D(tm, iterations=6, contact_ke=2.0e4)
    js, ts, rows = jm.state(), tm.state(), {}

    def figures(q, active):
        return dict(z_max=float(q[:, 2].max()),
                    seam_gap=float(np.linalg.norm(q[sa] - q[sb],
                                                  axis=-1).mean()),
                    active_contacts=int(active))
    for f in range(1, args.frames + 1):
        js = frame(js)
        for _ in range(n):
            ts = tsolver.step(ts, None, None, tp.collide(ts), dt)
        if f % 5 == 0:
            jq, tq = np.asarray(js.particle_q), ts.particle_q.numpy()
            rows[f] = dict(
                jax=figures(jq, np.asarray(jp.collide(js)
                                           .soft_contact_mask).sum()),
                port=figures(tq, tp.collide(ts).soft_contact_mask.sum()),
                max_vertex_diff=float(np.abs(jq - tq).max()))
    print(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
