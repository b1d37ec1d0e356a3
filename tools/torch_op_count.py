#!/usr/bin/env python3
"""Operations one substep runs on each host-bound path of the port that
sums with a scatter, counted on the CPU.

    python3 tools/torch_op_count.py

Counts the aten calls of one substep (after one warm-up substep) with a
``TorchDispatchMode`` (every call that reaches the dispatcher, and among
them the view and reshape calls, which launch nothing on a card) for:
the ant under ``SolverXPBD(iterations=8)`` (``chip_smoke.py`` phase 21's
configuration at 8 worlds: the count does not depend on the worlds, and
collide is left out), ``SolverStyle3D(iterations=4)`` and
``SolverVBD(iterations=4)`` on ``bench.py --mode cloth``'s 100 x 100
cloth, the Style3D garment with its soft contacts, the same garment under
``SolverVBD(iterations=4)`` (its soft-contact sums), and
``SolverSemiImplicit`` on the 6 x 6 test cloth and the soft block. Prints
one JSON object. Run it in two checkouts to compare them. A count is a
prediction of the device operations per substep; only a profile on the
card measures them.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

VIEWS = ("view", "unsqueeze", "select", "slice", "expand", "unbind",
         "alias", "transpose", "squeeze", "permute", "as_strided",
         "_reshape_alias", "unflatten")


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

    def count(solver, state, dt, pipe=None, control=None):
        contacts = pipe.collide(state) if pipe else None
        state = solver.step(state, None, control, contacts, dt)
        contacts = pipe.collide(state) if pipe else None
        c = Count()
        with c:
            solver.step(state, None, control, contacts, dt)
        return dict(aten_calls=c.calls, views=c.views,
                    compute=c.calls - c.views)

    out = {}
    robot = nt.ModelBuilder()
    robot.add_mjcf(os.path.join(nt.ASSET_DIR, "ant.xml"))
    b = nt.ModelBuilder()
    b.replicate(robot, 8)
    m = b.finalize("cpu")
    gen = torch.Generator().manual_seed(0)
    ctl = m.control()
    ctl.joint_f = cs.ant_xpbd_ctrl(m, gen)
    state = nt.eval_fk(m, m.joint_q0, m.joint_qd0, m.state())
    out["xpbd_ant"] = count(nt.SolverXPBD(m, iterations=cs.XPBD_ITERS),
                            state, cs.DT, nt.CollisionPipeline(m), ctl)
    bench = cs.cloth_bench_scene(nt).finalize("cpu")
    out["style3d_bench"] = count(nt.SolverStyle3D(bench, iterations=4),
                                 bench.state(), cs.DT)
    out["vbd_bench"] = count(nt.SolverVBD(bench, iterations=4),
                             bench.state(), cs.DT)
    m = cs.garment_scene(nt)[0].finalize("cpu")
    out["style3d_garment"] = count(
        nt.SolverStyle3D(m, iterations=6, contact_ke=2.0e4), m.state(),
        cs.GARMENT_DT, nt.CollisionPipeline(m))
    out["vbd_garment"] = count(nt.SolverVBD(m, iterations=4), m.state(),
                               cs.GARMENT_DT, nt.CollisionPipeline(m))
    for label, scene in (("semi_cloth", cs.small_cloth_scene),
                         ("semi_soft_block", cs.soft_grid_scene)):
        m = scene(nt).finalize("cpu")
        out[label] = count(nt.SolverSemiImplicit(m), m.state(), cs.SEMI_DT)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
