#!/usr/bin/env python3
"""How the bench cloth behaves under SolverVBD, in the JAX package and
in the port, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/cloth_vbd_blowup.py [--dim 100]
        [--frames 30] [--edge-ke 1.0] [--solver vbd|style3d] [--out FILE]

Steps ``bench.py --mode cloth``'s cloth (``chip_smoke.cloth_bench_scene``:
a (dim + 1)^2 grid of cell 0.01 pinned along its top row at z = 2, mass
2, tri_ke 500, the given edge_ke) under ``SolverVBD(iterations=4)`` (or
``SolverStyle3D(iterations=4)``), dt 1/240, 4 substeps per frame, in both
packages from rest, and prints one JSON object: for each package and for
frames 1, 2, 3, 5, 10, 15, ... the largest triangle-edge stretch (length
over rest length), the largest particle speed component, the free
vertices' mean z and whether the state is finite. The two packages part
after a few substeps where the cloth does not hold, so they are compared
by these figures, not vertex by vertex.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _scene(lib, dim, edge_ke):
    b = lib.ModelBuilder()
    b.add_cloth_grid(pos=(0, 0, 2.0), dim_x=dim, dim_y=dim, cell_x=0.01,
                     cell_y=0.01, mass=2.0, fix_top=True, tri_ke=500.0,
                     edge_ke=edge_ke)
    return b


def _figures(q, qd, q0, tri, free):
    import numpy as np
    e = np.linalg.norm(q[tri[:, 0]] - q[tri[:, 1]], axis=-1)
    e0 = np.linalg.norm(q0[tri[:, 0]] - q0[tri[:, 1]], axis=-1)
    return dict(stretch_max=float((e / e0).max()),
                speed_max=float(np.abs(qd).max()),
                free_z_mean=float(q[free, 2].mean()),
                finite=bool(np.isfinite(q).all()))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=100)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--edge-ke", type=float, default=1.0)
    ap.add_argument("--solver", choices=("vbd", "style3d"), default="vbd")
    ap.add_argument("--out")
    args = ap.parse_args()
    import jax
    import numpy as np
    import torch
    import newton_tpu as jt
    import newton_tpu_torch as nt
    from newton_tpu import solvers as js
    dt, report = 1.0 / 240.0, {}
    marks = {1, 2, 3} | set(range(5, args.frames + 1, 5))
    name = "SolverVBD" if args.solver == "vbd" else "SolverStyle3D"

    jm = _scene(jt, args.dim, args.edge_ke).finalize()
    solver = getattr(js, name)(jm, iterations=4)

    @jax.jit
    def frame(s):
        def sub(s, _):
            return solver.step(s, None, None, None, dt), None
        return jax.lax.scan(sub, s, None, length=4)[0]
    q0 = np.asarray(jm.particle_q)
    tri = np.asarray(jm.tri_indices)
    free = np.asarray(jm.particle_inv_mass) > 0
    s, out = jm.state(), {}
    for f in range(1, args.frames + 1):
        s = frame(s)
        if f in marks:
            out[f] = _figures(np.asarray(s.particle_q),
                              np.asarray(s.particle_qd), q0, tri, free)
    report["jax"] = out

    tm = _scene(nt, args.dim, args.edge_ke).finalize("cpu")
    solver = getattr(nt, name)(tm, iterations=4)
    s, out = tm.state(), {}
    for f in range(1, args.frames + 1):
        for _ in range(4):
            s = solver.step(s, None, None, None, dt)
        if f in marks:
            out[f] = _figures(s.particle_q.numpy(), s.particle_qd.numpy(),
                              q0, tri, free)
    report["port"] = out
    report["config"] = dict(dim=args.dim, frames=args.frames,
                            edge_ke=args.edge_ke, solver=name,
                            torch=torch.__version__)
    text = json.dumps(report, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text)


if __name__ == "__main__":
    main()
