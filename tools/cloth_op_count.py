#!/usr/bin/env python3
"""Operations one substep of each cloth solver runs, and the cloth
scenes' host setup, counted on the CPU.

    python3 tools/cloth_op_count.py

Counts the aten calls of one substep (after one warm-up substep) with a
``TorchDispatchMode`` (every call that reaches the dispatcher, and the
view and reshape calls among them, which launch nothing on a card) for
``SolverStyle3D(iterations=4)`` and ``SolverVBD(iterations=4)`` on
``bench.py --mode cloth``'s 100 x 100 cloth, the Style3D garment with its
soft contacts (collide included), and ``SolverSemiImplicit`` on the 6 x
6 test cloth and the soft block (``chip_smoke.py``'s scenes), then times
the bench cloth's builder and finalize and each solver's construction on
this host. Prints one JSON object. A count is a prediction of the
device operations per substep; only a profile on the card measures
them.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

VIEWS = ("view", "unsqueeze", "select", "slice", "expand", "unbind",
         "alias", "transpose", "squeeze", "permute", "as_strided",
         "_reshape_alias")


def main():
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    import chip_smoke as cs
    import newton_tpu_torch as nt

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls = self.views = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.calls += 1
            self.views += any(v in str(func) for v in VIEWS)
            return func(*args, **(kwargs or {}))

    def count(solver, state, dt, pipe=None):
        state = solver.step(state, None, None,
                            pipe.collide(state) if pipe else None, dt)
        c = Count()
        with c:
            solver.step(state, None, None,
                        pipe.collide(state) if pipe else None, dt)
        return dict(aten_calls=c.calls, views=c.views,
                    compute=c.calls - c.views)

    out = {}
    bench = cs.cloth_bench_scene(nt).finalize("cpu")
    out["style3d_bench"] = count(nt.SolverStyle3D(bench, iterations=4),
                                 bench.state(), cs.DT)
    out["vbd_bench"] = count(nt.SolverVBD(bench, iterations=4),
                             bench.state(), cs.DT)
    m = cs.garment_scene(nt)[0].finalize("cpu")
    out["style3d_garment"] = count(
        nt.SolverStyle3D(m, iterations=6, contact_ke=2.0e4), m.state(),
        cs.GARMENT_DT, nt.CollisionPipeline(m))
    for label, scene in (("semi_cloth", cs.small_cloth_scene),
                         ("semi_soft_block", cs.soft_grid_scene)):
        m = scene(nt).finalize("cpu")
        out[label] = count(nt.SolverSemiImplicit(m), m.state(), cs.SEMI_DT)
    t0 = time.perf_counter()
    m = cs.cloth_bench_scene(nt).finalize("cpu")
    t1 = time.perf_counter()
    nt.SolverStyle3D(m, iterations=4)
    t2 = time.perf_counter()
    nt.SolverVBD(m, iterations=4)
    t3 = time.perf_counter()
    out["host_s"] = dict(builder_and_finalize=t1 - t0, style3d_init=t2 - t1,
                         vbd_init=t3 - t2)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
