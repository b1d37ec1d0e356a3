"""``SolverVBD``'s rigid bodies (AVBD) in the port against the JAX package
on the CPU: the two-box stack of example_vbd_rigid_rigid_contact.py
(replicated x 2; static slots, persistent manifolds and dynamic-pair
Contacts), the ball pendulum, a FIXED joint's rotation lock, the cable
rod, a cloth and a body stepped together, a kinematic body in a contact
(its identity system); the JAX package's gates of tests/test_solvers.py:
319 and tests/test_cable.py:121 on the port (tests/test_torch_avbd_gates.py);
the reference defect C.33
(AVBD launches a light box tower, ROADMAP C) pinned in both packages; the
float64 plain versions of B1 and B2 against their float32 ones, and the
float64 AVBD substep against the float32 one. On a CUDA card: a substep
of the replicated stack on the card against the CPU, and two card runs
of it bit for bit.

Tolerances: body_q and joint_q atol = rtol = 2e-4, body_qd, joint_qd and
particle_qd 5e-3 (tests/test_batched_step.py:69-75); the gates are the
JAX tests'. The JAX package solves AVBD's 6x6 systems by LU
(``jnp.linalg.solve``), the port by Cholesky (B1's ``chol_solve``): they
agree to float32 rounding, but a contact whose penetration or multiplier
sits at the activation threshold ((pen > 0) | (lam > 0)) parts the two
runs once both boxes rest on each other, and the box-box manifold's
rows, mirrored in y, cancel there to the last bit in the JAX package but
leave a rounding residue in the port (its persistent manifolds' points
are held to the JAX package's at 1e-5, not bit for bit), which the stiff
penalty amplifies within a few substeps. So the stack is compared from
the start through the second box's landing (with persistent manifolds:
through the first box's rest, 52 substeps), and from the JAX package's
settled state at a later frame. The JAX package's gates of the slice
are in tests/test_torch_avbd_gates.py.

JAX is imported inside the tests, so the GPU cases collect where JAX is
absent (the card's machine)::

    python -m pytest -o addopts="" --noconftest -m gpu tests/test_torch_avbd.py
"""

import os
import sys

import numpy as np
import pytest
import torch

import newton_tpu_torch as nt
from newton_tpu_torch.solvers.generalized import linalg, pgs

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke as cs  # noqa: E402  (the scenes of phase 52)
from test_torch_free_bodies import _pair, _port_state  # noqa: E402

torch.set_num_threads(1)

QTOL, QDTOL = 2e-4, 5e-3
DT = 1.0 / 240.0
gpu = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _stack2(lib):
    return cs.vbd_stack_scene(lib, 2)


def _fixed(lib):
    """A box on a revolute hinge about Y with a bar welded to it by a
    FIXED joint: the weld and the rotation lock carry the bar."""
    b = lib.ModelBuilder()
    a = b.add_body(xform=[0, 0, 1.0, 0, 0, 0, 1])
    b.add_shape_box(a, hx=0.1, hy=0.1, hz=0.1)
    b.add_joint_revolute(-1, a, axis="Y", xform_p=[0, 0, 1.0, 0, 0, 0, 1])
    c = b.add_body(xform=[0.3, 0, 1.0, 0, 0, 0, 1])
    b.add_shape_box(c, hx=0.15, hy=0.05, hz=0.05)
    b.add_joint_fixed(a, c, xform_p=[0.3, 0, 0, 0, 0, 0, 1])
    return b


def _cloth_body(lib):
    """A free ball resting on the ground under a falling 4 x 4 cloth: the
    particle sweep and AVBD in one step, soft and rigid contacts."""
    b = lib.ModelBuilder()
    body = b.add_body(xform=[0.15, 0.15, 0.2, 0, 0, 0, 1])
    b.add_shape_sphere(body, radius=0.2)
    b.add_joint_free(body)
    b.add_ground_plane()
    b.add_cloth_grid(pos=(0, 0, 0.45), dim_x=4, dim_y=4, cell_x=0.1,
                     cell_y=0.1, mass=1.0, fix_top=False, tri_ke=500.0,
                     edge_ke=1.0)
    return b


def _kinematic(lib):
    """A box resting on a kinematic slab (a body without mass and
    without a joint, moving at its initial velocity)."""
    b = lib.ModelBuilder()
    slab = b.add_body(xform=[0, 0, 0.1, 0, 0, 0, 1], mass=0.0)
    b.add_shape_box(slab, hx=0.5, hy=0.5, hz=0.1,
                    cfg=lib.ShapeConfig(density=0.0))
    box = b.add_body(xform=[0, 0, 0.3, 0, 0, 0, 1])
    b.add_shape_box(box, hx=0.1, hy=0.1, hz=0.1)
    b.add_joint_free(box)
    return b


def _close_states(tst, jst, what):
    for name, tol in (("body_q", QTOL), ("body_qd", QDTOL),
                      ("joint_q", QTOL), ("joint_qd", QDTOL),
                      ("particle_q", QTOL), ("particle_qd", QDTOL)):
        got = getattr(tst, name)
        if got.numel():
            np.testing.assert_allclose(got.numpy(),
                                       np.asarray(getattr(jst, name)),
                                       atol=tol, rtol=tol,
                                       err_msg=f"{what}: {name}")


def _lockstep(make, substeps, iterations=8, pipe_kw=None, persistent=False,
              skip=0, fk=True, qd=None):
    """``substeps`` of ``make(lib)`` under SolverVBD in both packages,
    every substep held to the tolerances. With ``skip``, the JAX package
    first runs that many substeps alone and hands its state (and
    persistent Contacts) over. ``pipe_kw`` None: no contacts. Returns
    the port's (model, solver, state)."""
    import jax
    import newton_tpu.solvers as js
    from newton_tpu.sim.articulation import eval_fk as j_eval_fk
    from newton_tpu.sim.collide import CollisionPipeline as JPipe
    from newton_tpu_torch.utils import bridge
    jm, tm = _pair(make)
    jsol = js.SolverVBD(jm, iterations=iterations)
    tsol = nt.SolverVBD(tm, iterations=iterations)
    use = pipe_kw is not None
    kw = dict(pipe_kw or {}, persistent_manifolds=persistent)
    jp = JPipe(jm, **kw) if use else None
    tp = nt.CollisionPipeline(tm, **kw) if use else None
    jst = j_eval_fk(jm, jm.joint_q0, jm.joint_qd0, jm.state()) if fk \
        else jm.state()
    if qd is not None:
        jst = jst.replace(body_qd=jax.numpy.asarray(qd, jst.body_qd.dtype))
    jc = jp.contacts() if persistent else None

    def sub(s, c):
        if not use:
            return jsol.step(s, None, None, None, DT), c
        cc = jp.collide(s, prev=c) if persistent else jp.collide(s)
        return jsol.step(s, None, None, cc, DT), cc if persistent else c
    step = jax.jit(sub)
    for _ in range(skip):
        jst, jc = step(jst, jc)
    tst = _port_state(jst)
    tc = None
    if persistent:
        tc = bridge.contacts_from_numpy(_jax_contacts(jc), "cpu")
    for k in range(substeps):
        jst, jc = step(jst, jc)
        if use:
            tc = tp.collide(tst, prev=tc) if persistent else tp.collide(tst)
        tst = tsol.step(tst, None, None, tc, DT)
        _close_states(tst, jst, f"substep {skip + k}")
    return tm, tsol, tst


def _jax_contacts(jc):
    from newton_tpu_torch.utils import bridge
    names = bridge.CONTACT_FIELDS + bridge.CONTACT_COUNTERS \
        + bridge.CONTACT_OPTIONAL
    d = {n: None if getattr(jc, n, None) is None
         else np.asarray(getattr(jc, n)) for n in names}
    d["custom"] = {k: np.asarray(v) for k, v in jc.custom.items()}
    return d


# ----------------------------------------------------------------------
# parity with the JAX package
# ----------------------------------------------------------------------
@pytest.mark.parametrize("persistent", [False, True],
                         ids=["static", "persistent"])
def test_box_stack_matches_jax(persistent):
    """example_vbd_rigid_rigid_contact.py replicated x 2: from the drop
    through the upper box's landing on the lower (64 substeps; 52 with
    persistent manifolds, see the module's docstring), every substep held
    to the JAX package; then 4 substeps from its settled state after
    150."""
    _lockstep(_stack2, 52 if persistent else 64, pipe_kw={},
              persistent=persistent)
    _lockstep(_stack2, 4, pipe_kw={}, persistent=persistent, skip=150)


def test_box_stack_dynamic_pairs_match_jax():
    """The same stack through the dynamic-pair pipeline: the contact
    bodies read on the device, the slots' sums in a DynamicOrderSum."""
    _lockstep(_stack2, 24, pipe_kw={"mode": "dynamic"})


@pytest.mark.parametrize("scene", ["pendulum", "fixed", "cable"])
def test_joints_match_jax(scene):
    """Joints without contacts for 40 substeps: the ball pendulum of
    tests/test_solvers.py:319 (iterations 6), a FIXED weld on a hinged
    box, and tests/test_cable.py:121's rod at bend_ke 500 (iterations 6;
    the split stretch/shear and bend/twist stiffness)."""
    make = {"pendulum": cs.vbd_pendulum_scene, "fixed": _fixed,
            "cable": lambda lib: cs.vbd_rod_scene(lib, 1, 500.0)}[scene]
    _lockstep(make, 40, iterations=6)


def test_cloth_and_body_match_jax():
    """A cloth falling onto a resting ball: the particle sweep with its
    soft contacts and AVBD's rigid contacts in one step, 30 substeps."""
    _lockstep(_cloth_body, 30, iterations=4, pipe_kw={}, fk=False)


def test_kinematic_body_matches_jax():
    """A box resting on a moving kinematic slab: the slab's (singular)
    Hessian is replaced by the identity and it keeps its motion; 20
    substeps."""
    qd = np.zeros((2, 6), np.float32)
    qd[0, 0] = 0.2
    m = _lockstep(_kinematic, 20, pipe_kw={}, fk=False, qd=qd)[2]
    assert np.isfinite(m.body_q.numpy()).all()


def _roll(m, solver, pipe, frames, substeps=4, dt=DT, state=None):
    s = nt.eval_fk(m, m.joint_q0, m.joint_qd0, m.state()) \
        if state is None else state
    for _ in range(frames * substeps):
        s = solver.step(s, None, None, None if pipe is None
                        else pipe.collide(s), dt)
    return s


# ----------------------------------------------------------------------
# C.33
# ----------------------------------------------------------------------
def test_jax_avbd_launches_a_light_tower():
    """Reference defect C.33 (ROADMAP C), pinned: example_xpbd_vbd_coupled.
    py's tower (four boxes of half-size 0.08, mu 0.7) under SolverVBD(
    iterations=8) alone launches box 1 above z = 0.3 (its rest height is
    0.242) within 5 frames, in the JAX package and in the port alike: the
    bodies' Jacobi sweep diverges once the contacts' penalty outweighs a
    light box's inertia. The two runs are not compared step by step (the
    divergence amplifies rounding)."""
    import jax
    import newton_tpu.solvers as js
    from newton_tpu.sim.collide import CollisionPipeline as JPipe
    jm, tm = _pair(lambda lib: cs.mixed_tower_scene(lib, 1))
    jsol, jp = js.SolverVBD(jm, iterations=8), JPipe(jm)

    step = jax.jit(lambda s: jsol.step(s, None, None, jp.collide(s), DT))
    s = jm.state()
    jz = []
    for _ in range(5):
        for _ in range(4):
            s = step(s)
        jz.append(float(s.body_q[1, 2]))
    tsol, tp = nt.SolverVBD(tm, iterations=8), nt.CollisionPipeline(tm)
    t = tm.state()
    tz = []
    for _ in range(5):
        t = _roll(tm, tsol, tp, 1, state=t)
        tz.append(float(t.body_q[1, 2]))
    assert max(jz) > 0.3 and max(tz) > 0.3, (jz, tz)


# ----------------------------------------------------------------------
# float64 plain versions (the witness of the card-vs-CPU checks)
# ----------------------------------------------------------------------
def test_float64_twins_match_float32():
    """B1's and B2's plain versions in float64 (through the wrappers, on
    the CPU) agree with the float32 ones within float32 rounding of the
    result's scale, and an AVBD substep of the stack in float64 agrees
    with the float32 one at the step tolerances."""
    from newton_tpu_torch.sim.state import map_tensors
    rng = np.random.default_rng(5)
    W, d = 64, 6
    A = rng.normal(size=(W, d, d))
    M = torch.as_tensor(A @ A.transpose(0, 2, 1) + d * np.eye(d))
    rhs = torch.as_tensor(rng.normal(size=(W, d)))
    Minv64, x64 = linalg.chol_inv_solve(M, rhs)
    Minv32, x32 = linalg.chol_inv_solve(M.float(), rhs.float())
    for a, b in ((Minv32, Minv64), (x32, x64),
                 (linalg.chol_solve(M.float(), rhs.float()),
                  linalg.chol_solve(M, rhs))):
        assert a.dtype == torch.float32 and b.dtype == torch.float64
        assert float((a.double() - b).abs().max()) <= 1e-5 * float(
            b.abs().max())
    c, nl = 4, 2
    J = torch.as_tensor(rng.normal(size=(W, 3 * c, d)))
    r = 3 * c + 2 * nl
    args = (J, Minv64, torch.as_tensor(rng.normal(size=(W, d))),
            torch.as_tensor(np.abs(rng.normal(size=(W, r)))),
            torch.ones(W, r, dtype=torch.float64),
            torch.full((W, c), 0.5, dtype=torch.float64),
            torch.zeros(W, r, dtype=torch.float64))
    kw = dict(c=c, ld=torch.tensor([1, 4]), iters=8, omega=1.0,
              use_cone=True, diag_scale=1.0, reg=1e-3, return_halvings=True)
    lam64, dqd64, h64 = pgs.pgs_solve_fused(*args, **kw)
    lam32, dqd32, h32 = pgs.pgs_solve_fused(*(a.float() for a in args), **kw)
    same = h32 == h64
    assert int(same.sum()) >= W - 1
    for a, b in ((lam32, lam64), (dqd32, dqd64)):
        assert a.dtype == torch.float32 and b.dtype == torch.float64
        assert float((a.double() - b)[same].abs().max()) <= 1e-4 * float(
            b.abs().max())

    def f64(x):
        return map_tensors(x, lambda t: t.double() if t.is_floating_point()
                           else t)
    m32 = _stack2(nt).finalize("cpu")
    m64 = f64(m32)
    outs = []
    for m in (m32, m64):
        s = m.state()
        solver, pipe = nt.SolverVBD(m, iterations=8), nt.CollisionPipeline(m)
        for _ in range(24):
            s = solver.step(s, None, None, pipe.collide(s), DT)
        outs.append(s)
    assert outs[1].body_q.dtype == torch.float64
    _close_states(outs[0], map_tensors(outs[1], lambda t: t.numpy()),
                  "float32 vs float64")


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
@gpu
def test_stack_substep_on_card(cuda):
    """Phase 52's main path at 8 worlds: 4 substeps on the card equal the
    CPU's at the step tolerances, one B1 solve per sweep; two card runs
    of a substep are equal bit for bit."""
    b = cs.vbd_stack_scene(nt, 8)
    outs = []
    for dev in (cuda, "cpu"):
        m = b.finalize(dev)
        solver = nt.SolverVBD(m, iterations=8)
        pipe = nt.CollisionPipeline(m)
        s = m.state()
        n0 = linalg.chol_solve.launches
        for _ in range(4):
            s = solver.step(s, None, None, pipe.collide(s), DT)
        if dev != "cpu":
            assert linalg.chol_solve.launches - n0 == 4 * 8
            c = pipe.collide(s)
            a = solver.step(s, None, None, c, DT)
            a2 = solver.step(s, None, None, c, DT)
            assert torch.equal(a.body_q, a2.body_q)
            assert torch.equal(a.body_qd, a2.body_qd)
        outs.append(s.to("cpu"))
    _close_states(outs[0], outs[1], "card vs CPU")
