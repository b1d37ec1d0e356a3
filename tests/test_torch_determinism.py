"""Fixed-order sums in the port (ROADMAP C.17): ``FixedOrderSum`` and the
tables each solver builds from it hold against ``index_add_`` on the CPU
(1e-6 relative): the XPBD joint and contact sums, Style3D's matvec and
right-hand side, VBD's soft-contact penalties, SemiImplicit's particle
forces and the actuators' torques into shared dofs; the solvers take
only Contacts whose slots are the static pipeline's, the destinations
those sums were built from. On a CUDA card: two
runs of one substep of each path (the XPBD ant, Style3D, VBD with soft
contacts, SemiImplicit with soft contacts) are equal bit for bit.

    python -m pytest -o addopts="" --noconftest -m gpu tests/test_torch_determinism.py
"""

import os
import sys

import numpy as np
import pytest
import torch

import newton_tpu_torch as nt
from newton_tpu_torch.core.segment_sum import FixedOrderSum

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke as cs  # noqa: E402  (the scenes of phases 21-27)

torch.set_num_threads(1)

DT = 1.0 / 240.0
RTOL = 1e-6
gpu = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _index_add(dst, n, terms, dim=0):
    keep = torch.as_tensor(np.asarray(dst) >= 0)
    shape = list(terms.shape)
    shape[dim] = n
    out = terms.new_zeros(shape)
    return out.index_add_(dim, torch.as_tensor(np.asarray(dst))[keep],
                          terms.index_select(dim, torch.nonzero(keep)[:, 0]))


def _close(a, b):
    scale = max(float(b.abs().max()), 1e-30)
    assert float((a - b).abs().max()) <= RTOL * scale


@pytest.mark.parametrize("case", ["scatter", "with_drops", "unique",
                                  "axis_1", "empty_dest"])
def test_fixed_order_sum_matches_index_add(case):
    rng = np.random.RandomState(0)
    n, m = 40, 300
    dst = rng.randint(0, n, m)
    dim, shape = 0, (m, 3)
    if case == "with_drops":
        dst[rng.rand(m) < 0.3] = -1
    elif case == "unique":
        dst = rng.permutation(n)[:30]
        shape = (30, 2, 3)
    elif case == "axis_1":
        dim, shape = 1, (5, m, 2)
    elif case == "empty_dest":
        dst = np.where(dst == 7, 8, dst)
    terms = torch.as_tensor(rng.randn(*shape).astype(np.float32))
    s = FixedOrderSum(dst, n, "cpu")
    got = s(terms, dim=dim)
    _close(got, _index_add(dst, n, terms, dim))
    assert torch.equal(got, s(terms.clone(), dim=dim))
    if case == "unique":
        assert s.max_degree == 1
    with pytest.raises(ValueError):
        s(terms[:-1] if dim == 0 else terms[:, :-1], dim=dim)


def test_xpbd_sums_match_index_add():
    """The XPBD plan's joint + contact sum and its contact sum on the ant
    x 4: each row's destination the child/parent of its joint or the
    body of its slot's shape (static sides dropped)."""
    b = nt.ModelBuilder()
    robot = nt.ModelBuilder()
    robot.add_mjcf(os.path.join(nt.ASSET_DIR, "ant.xml"))
    b.replicate(robot, 4)
    b.add_ground_plane()
    m = b.finalize("cpu")
    solver = nt.SolverXPBD(m, iterations=2)
    plan = solver._plan
    st = m.structure
    C = st.rigid_contact_max
    contact, both = plan.sums(C)
    sb = np.asarray(st.shape_body)
    s0, s1 = np.asarray(st.slot_shape0), np.asarray(st.slot_shape1)
    cdst = np.concatenate([np.where(s1 >= 0, sb[np.maximum(s1, 0)], -1),
                           np.where(s0 >= 0, sb[np.maximum(s0, 0)], -1)])
    parent = np.asarray(st.joint_parent)
    jdst = np.concatenate([np.asarray(st.joint_child),
                           np.where(parent >= 0, parent, -1)])
    rng = np.random.RandomState(1)
    rows = torch.as_tensor(rng.randn(2 * C, 6).astype(np.float32))
    _close(contact(rows), _index_add(cdst, st.body_count, rows))
    rows = torch.as_tensor(rng.randn(len(jdst) + 2 * C, 7)
                           .astype(np.float32))
    _close(both(rows), _index_add(np.concatenate([jdst, cdst]),
                                  st.body_count, rows))
    with pytest.raises(ValueError):
        plan.sums(C + 1)


def test_style3d_matvec_and_rhs_match_index_add():
    """Style3D's neighbour-table matvec and right-hand-side sum against
    the two index_add_ scatters over the constraint list."""
    m = cs.garment_scene(nt)[0].finalize("cpu")
    solver = nt.SolverStyle3D(m, iterations=2)
    rng = np.random.RandomState(2)
    x = torch.as_tensor(rng.randn(m.particle_count, 3).astype(np.float32))
    diag = solver._diag(DT)
    a, b, w = solver._a, solver._b, solver.w
    ref = diag[:, None] * x
    ref.index_add_(0, a, -w[:, None] * x[b])
    ref.index_add_(0, b, -w[:, None] * x[a])
    _close(solver._apply_A(x, diag, w), ref)
    w2 = w * 1.5
    ref2 = diag[:, None] * x
    ref2.index_add_(0, a, -w2[:, None] * x[b])
    ref2.index_add_(0, b, -w2[:, None] * x[a])
    _close(solver._apply_A(x, diag, w2), ref2)
    contrib = torch.as_tensor(rng.randn(len(a), 3).astype(np.float32))
    got = (solver._nbr_sgn * contrib[solver._nbr_con]).sum(1)
    ref3 = torch.zeros_like(x).index_add_(0, a, contrib).index_add_(
        0, b, -contrib)
    _close(got, ref3)


def test_soft_contact_and_semi_implicit_sums_match_index_add():
    """VBD's and Style3D's soft-contact sum and SemiImplicit's force sum
    (springs, triangles, bending edges, soft contacts) against
    index_add_ of the same terms."""
    from newton_tpu_torch.core.segment_sum import soft_contact_sum
    m = cs.garment_scene(nt)[0].finalize("cpu")
    st = m.structure
    rng = np.random.RandomState(3)
    sp = np.asarray(st.soft_pairs).reshape(-1, 2)
    terms = torch.as_tensor(rng.randn(len(sp), 12).astype(np.float32))
    _close(soft_contact_sum(st, m.particle_count, "cpu")(terms),
           _index_add(sp[:, 0], m.particle_count, terms))
    solver = nt.SolverSemiImplicit(m)
    for soft in (False, True):
        dst = np.concatenate(solver._force_dst
                             + ([sp[:, 0]] if soft else []))
        terms = torch.as_tensor(rng.randn(len(dst), 3).astype(np.float32))
        _close(solver._force_sum(soft)(terms),
               _index_add(dst, m.particle_count, terms))


def test_actuator_torques_into_shared_dofs_match_index_add():
    """Two actuators on one dof: the fixed-order sum of their torques
    equals index_add_."""
    from newton_tpu_torch.solvers.generalized.actuation import (
        ActuationTables, MJCActuation, actuator_forces)
    au = MJCActuation(3)
    au.dof = np.array([1, 1, 0], np.int32)
    au.coord = np.array([1, 1, 0], np.int32)
    au.gear = np.array([1.0, 2.0, 0.5])
    au.finish()
    tab = ActuationTables(au, "cpu", n_dof=3)
    rng = np.random.RandomState(4)
    q = torch.as_tensor(rng.randn(5, 3).astype(np.float32))
    qd = torch.as_tensor(rng.randn(5, 3).astype(np.float32))
    ctrl = torch.as_tensor(rng.randn(5, 3).astype(np.float32))
    got = actuator_forces(tab, q, qd, ctrl)
    ref = torch.zeros(5, 3).index_add_(1, tab.dof, tab.gear * ctrl)
    _close(got, ref)


def _pyramid_contacts():
    m = cs.pyramid_scene(nt, 2)[0].finalize("cpu")
    s = nt.eval_fk(m, m.joint_q0, m.joint_qd0, m.state())
    return m, s, nt.CollisionPipeline(m).collide(s)


def test_xpbd_takes_the_static_slots_only():
    """The XPBD contact sums add into the bodies of the static pipeline's
    slots: the pipeline's own Contacts, or a copy of them without its
    mark (checked on the host), step to the same state; Contacts of the
    same size whose slots name other shapes raise."""
    from dataclasses import replace
    m, s, c = _pyramid_contacts()
    assert c.slots is m.structure
    solver = nt.SolverXPBD(m, iterations=2)
    a = solver.step(s, None, None, c, DT)
    b = solver.step(s, None, None, replace(c, slots=None), DT)
    assert torch.equal(a.body_q, b.body_q)
    unused = c.rigid_contact_shape0.clone()
    unused[~c.rigid_contact_mask] = -1
    solver.step(s, None, None, replace(c, slots=None,
                                       rigid_contact_shape0=unused), DT)
    for name in ("rigid_contact_shape0", "rigid_contact_shape1"):
        other = replace(c, slots=None, **{name: torch.roll(
            getattr(c, name), 1)})
        with pytest.raises(ValueError, match=name):
            solver.step(s, None, None, other, DT)


@pytest.mark.parametrize("name", ["style3d", "vbd", "semi_implicit"])
def test_soft_sums_take_the_static_slots_only(name):
    """The soft-contact sums add into the particles of the static
    pipeline's soft slots: Contacts whose soft slots name other particles
    raise in each cloth solver; an unmarked copy of the pipeline's steps
    as the pipeline's own."""
    from dataclasses import replace
    m = cs.garment_scene(nt)[0].finalize("cpu")
    s = m.state()
    s.particle_q[:, 2] -= 1.2
    c = nt.CollisionPipeline(m).collide(s)
    solver = {"style3d": lambda: nt.SolverStyle3D(m, iterations=2),
              "vbd": lambda: nt.SolverVBD(m, iterations=2),
              "semi_implicit": lambda: nt.SolverSemiImplicit(m)}[name]()
    a = solver.step(s, None, None, c, DT)
    b = solver.step(s, None, None, replace(c, slots=None), DT)
    assert torch.equal(a.particle_q, b.particle_q)
    other = replace(c, slots=None, soft_contact_particle=torch.roll(
        c.soft_contact_particle, 1))
    with pytest.raises(ValueError, match="soft_contact_particle"):
        solver.step(s, None, None, other, DT)


# ----------------------------------------------------------------------
# on the card: two runs of a substep, bit for bit
# ----------------------------------------------------------------------

def _repeat(solver, state, ctl, contacts, names):
    a = solver.step(state, None, ctl, contacts, DT)
    b = solver.step(state, None, ctl, contacts, DT)
    for n in names:
        assert torch.equal(getattr(a, n), getattr(b, n)), n


@gpu
def test_xpbd_ant_substep_repeats_bit_for_bit(cuda):
    robot = nt.ModelBuilder()
    robot.add_mjcf(os.path.join(nt.ASSET_DIR, "ant.xml"))
    b = nt.ModelBuilder()
    b.replicate(robot, 256)
    m = b.finalize(cuda)
    solver = nt.SolverXPBD(m, iterations=8)
    pipe = nt.CollisionPipeline(m)
    ctl = m.control()
    ctl.joint_f = cs.ant_xpbd_ctrl(m, torch.Generator(cuda).manual_seed(0))
    s = nt.eval_fk(m, m.joint_q0, m.joint_qd0, m.state())
    for _ in range(40):
        s = solver.step(s, None, ctl, pipe.collide(s), DT)
    _repeat(solver, s, ctl, pipe.collide(s), cs.REPEAT_FIELDS_RIGID)


@gpu
@pytest.mark.parametrize("name", ["style3d", "vbd", "semi_implicit"])
def test_cloth_substep_with_soft_contacts_repeats_bit_for_bit(cuda, name):
    """The garment lowered into the ground plane (active soft contacts):
    one substep of each cloth solver twice."""
    m = cs.garment_scene(nt)[0].finalize(cuda)
    s = m.state()
    s.particle_q[:, 2] -= 1.2
    c = nt.CollisionPipeline(m).collide(s)
    assert int((c.soft_contact_mask & (c.soft_contact_depth > 0)).sum())
    solver = {"style3d": lambda: nt.SolverStyle3D(m, iterations=4),
              "vbd": lambda: nt.SolverVBD(m, iterations=4),
              "semi_implicit": lambda: nt.SolverSemiImplicit(m)}[name]()
    _repeat(solver, s, None, c, ("particle_q", "particle_qd"))


@gpu
def test_bench_cloth_substep_repeats_bit_for_bit(cuda):
    m = cs.cloth_bench_scene(nt).finalize(cuda)
    solver = nt.SolverStyle3D(m, iterations=4)
    s = m.state()
    for _ in range(8):
        s = solver.step(s, None, None, None, DT)
    _repeat(solver, s, None, None, ("particle_q", "particle_qd"))
