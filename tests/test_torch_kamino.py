"""Parity: the port's ``SolverKamino`` (proximal ADMM over second-order
cones, the island plan and its blocked factorization) against the JAX
package's.

Tolerances: the island tables equal; the island solve equals the dense
solve within 5e-5 (q) and 5e-4 (qd) over 60 steps
(tests/test_kamino_islands.py's gate); the heavy stack, the four-bar and
the linkage over 8 substeps joint_q/body_q 2e-4 and joint_qd 5e-3 of the
JAX package's (the ant's substep tolerances).
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
import newton_tpu_torch as nt
from newton_tpu_torch.solvers import SolverKamino
from newton_tpu_torch.solvers.generalized.kamino import island_partition

torch.set_num_threads(1)

DT = 1.0 / 240.0


def test_exports():
    """``newton_tpu_torch.solvers`` exports the three generalized solvers,
    as ``newton_tpu.solvers`` does."""
    from newton_tpu_torch.solvers import (SolverFeatherstone,  # noqa: F401
                                          SolverKamino as K, SolverMuJoCo)
    import newton_tpu_torch.solvers as S
    assert {"SolverFeatherstone", "SolverKamino", "SolverMuJoCo"} \
        <= set(S.__all__)
    assert K is nt.SolverKamino


def test_island_partition_matches_jax():
    """build_stacks(3, 2): the port's island tables equal the JAX
    package's (rows in its interleaved order), three or more islands."""
    import newton_tpu as jt
    from newton_tpu.solvers import SolverKamino as JKamino
    from newton_tpu.solvers.generalized.solver import _island_partition
    jm = cs.stacks_scene(jt).finalize()
    tm = cs.stacks_scene(nt).finalize("cpu")
    js, ts = JKamino(jm), SolverKamino(tm)
    jg = js.gc.groups[0]
    ref = _island_partition(jg, js.contact_plans[0], js.limit_plans[0])
    grp = ts.groups[0]
    got = island_partition(grp.g, grp.plan, grp.limit_plan)
    assert got[1:] == ref[1:] and got[1] >= 3
    np.testing.assert_array_equal(got[0], ref[0])
    assert ts.island_plans[0] is not None
    assert grp.tables.cap == grp.plan.c            # uncapped rows


def _run(m, solver, steps):
    pipe = nt.CollisionPipeline(m)
    s = solver.init_state(nt.eval_fk(m, m.joint_q0, m.joint_qd0,
                                     m.state()))
    for _ in range(steps):
        s = solver.step(s, None, None, pipe.collide(s), DT)
    return s


def test_island_solve_matches_dense():
    """The blocked factorization against the dense one on build_stacks(3,
    2), contact_cap=0 on both: 60 steps within 5e-5 (q) and 5e-4 (qd)."""
    m = cs.stacks_scene(nt).finalize("cpu")
    si = SolverKamino(m, iterations=16, use_islands=True, contact_cap=0)
    sd = SolverKamino(m, iterations=16, use_islands=False, contact_cap=0)
    assert si.groups[0].tables.islands is not None
    assert sd.groups[0].tables.islands is None
    a, b = _run(m, si, 60), _run(m, sd, 60)
    np.testing.assert_allclose(a.body_q.numpy(), b.body_q.numpy(),
                               atol=5e-5)
    np.testing.assert_allclose(a.body_qd.numpy(), b.body_qd.numpy(),
                               atol=5e-4)


def _close(st, sj):
    for name, atol in (("joint_q", 2e-4), ("joint_qd", 5e-3),
                       ("body_q", 2e-4)):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   np.asarray(getattr(sj, name)), atol=atol,
                                   rtol=atol, err_msg=name)


@pytest.mark.parametrize("scene", ["heavy_stack", "fourbar", "linkage",
                                   "stacks"])
def test_scene_matches_jax(scene):
    """8 substeps of the heavy stack (iterations=8, contacts), the kicked
    four-bar (CONNECT loop, no contacts), the linkage and build_stacks(3,
    2) (the island path), the port's ``step`` against the JAX package's
    jitted ``step``."""
    import jax
    import jax.numpy as jnp
    import newton_tpu as jt
    from newton_tpu.sim.articulation import eval_fk as j_eval_fk
    from newton_tpu.sim.collide import CollisionPipeline as JPipe
    from newton_tpu.solvers import SolverKamino as JKamino
    make = {"heavy_stack": lambda lib: cs.heavy_stack_scene(lib, 1),
            "fourbar": lambda lib: cs.fourbar_scene(lib, 1),
            "linkage": lambda lib: cs.linkage_scene(lib, 1, "connect"),
            "stacks": lambda lib: cs.stacks_scene(lib)}[scene]
    kw = dict(iterations=8) if scene == "heavy_stack" else {}
    jm, tm = make(jt).finalize(), make(nt).finalize("cpu")
    js, ts = JKamino(jm, **kw), SolverKamino(tm, **kw)
    qd0 = np.zeros(tm.joint_dof_count, np.float32)
    if scene == "fourbar":
        qd0[0] = 2.0
    sj = js.init_state(j_eval_fk(jm, jm.joint_q0, jnp.asarray(qd0),
                                 jm.state()))
    st = ts.init_state(nt.eval_fk(tm, tm.joint_q0, torch.as_tensor(qd0),
                                  tm.state()))
    contacts = tm.structure.rigid_contact_max > 0
    jpipe, tpipe = JPipe(jm), nt.CollisionPipeline(tm)
    jc, tc = jm.control(), tm.control()

    @jax.jit
    def jstep(s):
        return js.step(s, None, jc, jpipe.collide(s) if contacts else None,
                       DT)
    for _ in range(8):
        sj = jstep(sj)
        st = ts.step(st, None, tc, tpipe.collide(st) if contacts else None,
                     DT)
    _close(st, sj)


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port, and chip_smoke.py, imported in a fresh
    interpreter: neither ``jax`` nor ``newton_tpu`` enters sys.modules."""
    import os
    import subprocess
    import sys
    code = (
        "import importlib, pkgutil, sys\n"
        "import newton_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or\n"
        "             k.startswith('jax.') or k == 'newton_tpu' or\n"
        "             k.startswith('newton_tpu.'))\n"
        "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    r = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
