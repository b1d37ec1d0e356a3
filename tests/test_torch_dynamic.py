"""The dynamic-pair collision pipeline in the port against the JAX package
on the CPU: ``compute_shape_aabbs`` and the three runtime broad phases,
dynamic-pair Contacts slot for slot (top-k ties included), the overflow
count, SAP at one world, the JAX SAP's lost pairs in late worlds (ROADMAP
C.26) against the port's full set, an XPBD pile on dynamic Contacts for a
few substeps, the per-call fixed-order sum against a float64
``index_add_``, and the refusals (a generalized solver, a batched state).
On a CUDA card: two runs of a dynamic substep bit for bit.

Tolerances: masks, shape indices and overflow counts exactly; AABBs,
contact points, normals and depths 1e-5 (float32 transform chains);
``step`` body_q atol 2e-4, body_qd 5e-3 (tests/test_batched_step.py:69-75).

    python -m pytest -o addopts="" --noconftest -m gpu tests/test_torch_dynamic.py
"""

import numpy as np
import pytest
import torch

import newton_tpu_torch as nt
from newton_tpu_torch.core.segment_sum import DynamicOrderSum
from newton_tpu_torch.geometry import broad_phase as t_bp

torch.set_num_threads(1)

ATOL = 1e-5
QTOL, QDTOL = 2e-4, 5e-3
CONTACT_INT = ("rigid_contact_mask", "rigid_contact_shape0",
               "rigid_contact_shape1")
CONTACT_FLOAT = ("rigid_contact_position", "rigid_contact_normal",
                 "rigid_contact_depth")

gpu = pytest.mark.gpu


def pile_scene(lib, worlds=2, n_side=2, layers=4, h=0.12, seed=7):
    """example_box_pile.py's pile at a small size: layers of n_side x
    n_side boxes of half-size h on free joints, jittered (seed), above a
    ground plane; replicated to ``worlds`` worlds."""
    sub = lib.ModelBuilder()
    rng = np.random.default_rng(seed)
    for layer in range(layers):
        for i in range(n_side):
            for j in range(n_side):
                x = (i - n_side / 2) * 0.3 + rng.uniform(-0.02, 0.02)
                y = (j - n_side / 2) * 0.3 + rng.uniform(-0.02, 0.02)
                body = sub.add_body(xform=[x, y, 0.3 + layer * 0.35, 0, 0,
                                           0, 1])
                sub.add_shape_box(body, hx=h, hy=h, hz=h)
                sub.add_joint_free(body)
    sub.add_ground_plane()
    b = lib.ModelBuilder()
    b.replicate(sub, worlds)
    return b


def grid_scene(lib, worlds=2):
    """Touching boxes in an exact grid (equal overlaps: ties in the
    scores) beside a sphere, a capsule and a box on a tilted grid, on a
    ground plane; ``worlds`` worlds."""
    sub = lib.ModelBuilder()
    for i in range(3):
        for j in range(2):
            body = sub.add_body(xform=[0.2 * i, 0.2 * j, 0.1, 0, 0, 0, 1])
            sub.add_shape_box(body, hx=0.11, hy=0.11, hz=0.11)
            sub.add_joint_free(body)
    q = [0.0, 0.0, 0.38268343, 0.92387953]
    for k, add in enumerate((
            lambda b: sub.add_shape_sphere(b, radius=0.12),
            lambda b: sub.add_shape_capsule(b, radius=0.06,
                                            half_height=0.1),
            lambda b: sub.add_shape_box(b, hx=0.1, hy=0.05, hz=0.08))):
        body = sub.add_body(xform=[0.7 + 0.15 * k, 0.1, 0.12] + q)
        add(body)
        sub.add_joint_free(body)
    sub.add_ground_plane()
    b = lib.ModelBuilder()
    b.replicate(sub, worlds)
    return b


def _jax_state_like(jm, q):
    s = jm.state()
    return s.replace(body_q=np.asarray(q, np.float32))


def _assert_contacts(got, ref, label=""):
    for name in CONTACT_INT:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=label + name)
    mask = np.asarray(ref.rigid_contact_mask)
    for name in CONTACT_FLOAT:
        np.testing.assert_allclose(getattr(got, name).numpy()[mask],
                                   np.asarray(getattr(ref, name))[mask],
                                   atol=ATOL, err_msg=label + name)
    assert int(got.broad_phase_dropped) == int(ref.broad_phase_dropped)


def _touching(c, n_per_world=None):
    """Unordered shape pairs of the active slots (per world when
    ``n_per_world`` shapes a world)."""
    mask = c.rigid_contact_mask.numpy() if isinstance(
        c.rigid_contact_mask, torch.Tensor) else np.asarray(
        c.rigid_contact_mask)
    s0 = np.asarray(c.rigid_contact_shape0)[mask]
    s1 = np.asarray(c.rigid_contact_shape1)[mask]
    pairs = {(min(a, b), max(a, b)) for a, b in zip(s0.tolist(),
                                                   s1.tolist())}
    if n_per_world is None:
        return pairs
    worlds = {}
    for a, b in pairs:
        worlds.setdefault(a // n_per_world, set()).add((a, b))
    return worlds


# ----------------------------------------------------------------------
# AABBs and the runtime broad phases
# ----------------------------------------------------------------------
def _all_types_scene(lib):
    """One turned shape of every analytic type on a free body, a static
    box, and a ground plane."""
    b = lib.ModelBuilder()
    q = [0.1, 0.2, 0.3, 0.9273618]
    adds = (lambda x: b.add_shape_sphere(x, radius=0.2),
            lambda x: b.add_shape_box(x, hx=0.2, hy=0.1, hz=0.3),
            lambda x: b.add_shape_capsule(x, radius=0.1, half_height=0.2),
            lambda x: b.add_shape_cylinder(x, radius=0.15, half_height=0.1),
            lambda x: b.add_shape_cone(x, radius=0.15, half_height=0.2),
            lambda x: b.add_shape_ellipsoid(x, rx=0.3, ry=0.2, rz=0.1))
    for i, add in enumerate(adds):
        body = b.add_body(xform=[0.35 * i, 0.1 * (i % 2), 0.4] + q)
        add(body)
        b.add_joint_free(body)
    b.add_shape_box(-1, xform=[0.8, 0.3, 0.2, 0, 0, 0, 1], hx=0.3, hy=0.1,
                    hz=0.2)
    b.add_ground_plane()
    return b


def test_compute_shape_aabbs_matches_jax():
    """Exact world AABBs of every primitive type (box |R| half; capsule,
    cylinder, cone axis-projected; ellipsoid row norms) and the plane's
    radius bound, with a margin, equal the JAX package's within 1e-5."""
    import newton_tpu as jt
    from newton_tpu.geometry.broad_phase import compute_shape_aabbs as j_ab
    jm = _all_types_scene(jt).finalize()
    tm = _all_types_scene(nt).finalize("cpu")
    ref = j_ab(jm, jm.state(), 0.01)
    got = t_bp.compute_shape_aabbs(tm, tm.state(), 0.01)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=1e-6)


@pytest.mark.parametrize("cls", ["BroadPhaseAllPairs", "BroadPhaseSAP",
                                 "BroadPhaseExplicit"])
def test_broad_phase_classes_match_jax(cls):
    """The three runtime broad phases on two worlds of the grid scene
    (touching and separated pairs, a world boundary): their pair lists and
    masks equal the JAX package's."""
    import newton_tpu as jt
    from newton_tpu.geometry import broad_phase as j_bp
    jm = grid_scene(jt).finalize()
    tm = grid_scene(nt).finalize("cpu")
    kw = dict(window=8) if cls == "BroadPhaseSAP" else {}
    ref = getattr(j_bp, cls)(jm, **kw).launch(jm.state())
    got = getattr(t_bp, cls)(tm, **kw).launch(tm.state())
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    assert got[1].any()


# ----------------------------------------------------------------------
# the dynamic-pair pipeline
# ----------------------------------------------------------------------
@pytest.mark.parametrize("scene, budget", [("grid", 40), ("grid", 10),
                                           ("pile", 64), ("pile", 16)])
def test_dynamic_contacts_match_jax(scene, budget):
    """``mode="dynamic"``: the slot count, every slot's mask and shape
    indices (top-k ties to the lower index, the grid's equal overlaps
    included), points, normals and depths, and ``broad_phase_dropped``
    equal the JAX pipeline's: at the start state and, for the pile, after
    its boxes fell 0.12 into each other."""
    import newton_tpu as jt
    from newton_tpu.sim.collide import CollisionPipeline as JPipe
    make = grid_scene if scene == "grid" else pile_scene
    jm, tm = make(jt).finalize(), make(nt).finalize("cpu")
    jp = JPipe(jm, mode="dynamic", dynamic_pair_budget=budget)
    tp = nt.CollisionPipeline(tm, mode="dynamic", dynamic_pair_budget=budget)
    assert tp.rigid_contact_max == jp.rigid_contact_max
    assert tp.rigid_contact_max < tm.structure.rigid_contact_max
    states = [np.asarray(jm.state().body_q)]
    if scene == "pile":
        q = states[0].copy()
        q[:, 2] -= 0.12 * (q[:, 2] > 0.5) + 0.05 * np.arange(len(q)) % 3
        states.append(q)
    for q in states:
        ref = jp.collide(_jax_state_like(jm, q))
        ts = tm.state()
        ts.body_q = torch.as_tensor(q)
        got = tp.collide(ts)
        assert got.dynamic and got.slots is None
        _assert_contacts(got, ref, f"{scene} {budget}: ")
    assert np.asarray(ref.rigid_contact_mask).any()


def test_overflow_count_at_budget_one():
    """tests/test_broad_phase.py:98 on the port: a 14-box stack with a
    budget of 1 (8 entries, the per-class floor) drops overlapping pairs
    and counts them, as the JAX pipeline does."""
    import newton_tpu as jt
    from newton_tpu.sim.collide import CollisionPipeline as JPipe

    def stack(lib):
        b = lib.ModelBuilder()
        for i in range(14):
            body = b.add_body(xform=[0, 0, 0.1 + 0.19 * i, 0, 0, 0, 1])
            b.add_shape_box(body, hx=0.1, hy=0.1, hz=0.1)
            b.add_joint_free(body)
        return b
    jm, tm = stack(jt).finalize(), stack(nt).finalize("cpu")
    ref = JPipe(jm, mode="dynamic", dynamic_pair_budget=1).collide(
        jm.state())
    got = nt.CollisionPipeline(tm, mode="dynamic",
                               dynamic_pair_budget=1).collide(tm.state())
    assert int(got.broad_phase_dropped) > 0
    _assert_contacts(got, ref)


def test_sap_matches_jax_one_world():
    """``broad_phase="sap"`` at one world (where the JAX sort key has no
    world offset): every slot equals the JAX pipeline's, and its touching
    pairs equal top-k's."""
    import newton_tpu as jt
    from newton_tpu.sim.collide import CollisionPipeline as JPipe
    jm = pile_scene(jt, worlds=1, n_side=3, layers=2).finalize()
    tm = pile_scene(nt, worlds=1, n_side=3, layers=2).finalize("cpu")
    q = np.asarray(jm.state().body_q).copy()
    q[:, 2] -= 0.12 * (q[:, 2] > 0.5)
    ts = tm.state()
    ts.body_q = torch.as_tensor(q)
    kw = dict(mode="dynamic", dynamic_pair_budget=200, broad_phase="sap",
              sap_window=8)
    ref = JPipe(jm, **kw).collide(_jax_state_like(jm, q))
    got = nt.CollisionPipeline(tm, **kw).collide(ts)
    _assert_contacts(got, ref)
    topk = nt.CollisionPipeline(tm, mode="dynamic",
                                dynamic_pair_budget=200).collide(ts)
    assert _touching(got) == _touching(topk) and _touching(got)


def _row_scene(lib, worlds=40, n=40, seed=0):
    """ROADMAP C.26's scene: in each of ``worlds`` worlds, n boxes of
    half-size 0.11 at a 0.2 pitch along x, in shuffled index order (seed)
    : 39 touching neighbours a world."""
    rng = np.random.default_rng(seed)
    b = lib.ModelBuilder()
    for w in range(worlds):
        b.begin_world()
        for i in rng.permutation(n):
            body = b.add_body(xform=[0.2 * i, 2.0 * w, 0.5, 0, 0, 0, 1])
            b.add_shape_box(body, hx=0.11, hy=0.11, hz=0.11)
            b.add_joint_free(body)
        b.end_world()
    return b


def test_jax_sap_drops_pairs_in_late_worlds():
    """ROADMAP C.26: the JAX SAP keeps worlds apart in one float32 sort by
    adding world * 1e6 to each AABB bound (newton_tpu/sim/collide.py:
    376-381, 394-397); from world ~34 the key's spacing (4.0) is coarser
    than the shapes, so its sweep loses touching pairs: JAX top-k finds 39
    in every world of the 40-world row scene, JAX SAP fewer in worlds
    34-39. The port's SAP (a stable sort on the bound, then on the world)
    finds top-k's 39 in every world."""
    import newton_tpu as jt
    from newton_tpu.sim.collide import CollisionPipeline as JPipe
    jm, tm = _row_scene(jt).finalize(), _row_scene(nt).finalize("cpu")
    kw = dict(mode="dynamic", dynamic_pair_budget=40000)
    n = 40
    jt_w = _touching(JPipe(jm, **kw).collide(jm.state()), n)
    js_w = _touching(JPipe(jm, broad_phase="sap", **kw).collide(jm.state()),
                     n)
    assert all(len(jt_w[w]) == 39 for w in range(40))
    lost = [w for w in range(40) if len(js_w.get(w, ())) < 39]
    assert set(range(34, 40)) <= set(lost), lost
    tt_w = _touching(nt.CollisionPipeline(tm, **kw).collide(tm.state()), n)
    ts_w = _touching(nt.CollisionPipeline(tm, broad_phase="sap",
                                          **kw).collide(tm.state()), n)
    assert tt_w == jt_w
    assert ts_w == tt_w


def test_sap_reach_tells_a_segmented_sweep_from_a_global_one():
    """``chip_smoke.sap_reach``, phase 47's gate: on the box pile of 4
    worlds with every layer compressed 5 mm into the next (a column's 24
    boxes share an x range, so a window of 16 misses some touching
    pairs), the port's SAP finds exactly the top-k pairs that the window
    reaches in each world's own order; a sweep of all worlds' shapes in
    one sort (the order C.26's key degrades to) does not."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke as cs
    m = cs.box_pile_scene(nt, 4).finalize("cpu")
    kw = dict(mode="dynamic", dynamic_pair_budget=8 * 96 * 4)
    s = cs.compressed_pile(m.state())
    topk = cs.touching_pairs(nt.CollisionPipeline(m, **kw).collide(s))
    sap = nt.CollisionPipeline(m, broad_phase="sap", sap_window=16, **kw)
    reach = cs.sap_reach(m, sap, s, topk)
    got = cs.touching_pairs(sap.collide(s))
    assert 0 < reach.numel() < topk.numel()
    assert torch.equal(got, reach)
    for pc in sap.classes:
        if getattr(pc, "sap", None) is not None:
            pc.sap.segment = False
    assert not torch.equal(cs.touching_pairs(sap.collide(s)), reach)


@pytest.mark.parametrize("broad_phase", ["topk", "sap"])
def test_xpbd_dynamic_pile_matches_jax(broad_phase):
    """An XPBD pile of 2 worlds x 16 boxes on dynamic-pair Contacts
    (budget 8 per box, the example's), SolverXPBD(iterations=4), dt
    1/120: 8 substeps of the port against the JAX package's, body_q
    within 2e-4 and body_qd within 5e-3 after every substep; the slots'
    bodies are summed by the per-call fixed-order sum."""
    import jax
    import newton_tpu as jt
    from newton_tpu.sim.collide import CollisionPipeline as JPipe
    from newton_tpu.solvers import SolverXPBD as JXPBD
    jm, tm = pile_scene(jt).finalize(), pile_scene(nt).finalize("cpu")
    kw = dict(mode="dynamic", dynamic_pair_budget=8 * 32,
              broad_phase=broad_phase)
    jp, tp = JPipe(jm, **kw), nt.CollisionPipeline(tm, **kw)
    js, ts = JXPBD(jm, iterations=4), nt.SolverXPBD(tm, iterations=4)
    step = jax.jit(lambda s: js.step(s, None, None, jp.collide(s), 1 / 120))
    jst, tst = jm.state(), tm.state()
    # start with each layer 5 mm into the one below and the ground
    q = np.asarray(jst.body_q).copy()
    q[:, 2] = 0.115 + 0.235 * np.round((q[:, 2] - 0.3) / 0.35)
    jst = jst.replace(body_q=q)
    tst.body_q = torch.as_tensor(q)
    for k in range(8):
        jst = step(jst)
        tst = ts.step(tst, None, None, tp.collide(tst), 1 / 120)
        np.testing.assert_allclose(tst.body_q.numpy(),
                                   np.asarray(jst.body_q), atol=QTOL,
                                   rtol=QTOL, err_msg=f"substep {k}")
        np.testing.assert_allclose(tst.body_qd.numpy(),
                                   np.asarray(jst.body_qd), atol=QDTOL,
                                   rtol=QDTOL, err_msg=f"substep {k}")
    assert tp.collide(tst).rigid_contact_mask.any()


@pytest.mark.parametrize("width", [1, 7])
def test_dynamic_order_sum_matches_float64(width):
    """``DynamicOrderSum`` of float32 terms with random destinations
    (negative ones dropped, empty destinations zero) against a float64
    ``index_add_``: within 1e-5; along another axis the same numbers."""
    rng = np.random.default_rng(width)
    n, n_dest = 5000, 300
    dst = rng.integers(-1, n_dest - 20, size=n)
    terms = rng.standard_normal((n, width)).astype(np.float32)
    s = DynamicOrderSum(torch.as_tensor(dst), n_dest)
    got = s(torch.as_tensor(terms))
    keep = dst >= 0
    ref = torch.zeros(n_dest, width, dtype=torch.float64).index_add_(
        0, torch.as_tensor(dst[keep]), torch.as_tensor(terms[keep],
                                                       dtype=torch.float64))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)
    assert (got[n_dest - 20:] == 0).all()
    t = s(torch.as_tensor(terms.T.copy()), dim=1)
    assert torch.equal(t.T, got)


def test_generalized_solver_refuses_dynamic_contacts():
    """A generalized solver's per-slot plan needs the static slots: it
    raises on dynamic-pair Contacts (the JAX package computes with them);
    a batched state with dynamic mode raises too, and so does a
    hydroelastic pipeline in dynamic mode (the JAX package's ignores the
    flag there)."""
    m = pile_scene(nt, worlds=1, n_side=2, layers=2).finalize("cpu")
    pipe = nt.CollisionPipeline(m, mode="dynamic", dynamic_pair_budget=8)
    c = pipe.collide(m.state())
    for solver in (nt.SolverMuJoCo(m, iterations=4),
                   nt.SolverFeatherstone(m)):
        with pytest.raises(ValueError, match="static"):
            solver.step(solver.init_state(m.state()) if hasattr(
                solver, "init_state") else m.state(), None, None, c, 1e-3)
    with pytest.raises(NotImplementedError, match="flat State"):
        pipe.collide(nt.batch_state(m.state(), 2))
    # hydroelastic contacts are ported, in static mode only
    assert nt.CollisionPipeline(m, hydroelastic=True).hydroelastic
    with pytest.raises(ValueError, match="static"):
        nt.CollisionPipeline(m, hydroelastic=True, mode="dynamic")
    auto = nt.CollisionPipeline(pile_scene(nt, n_side=3, layers=2)
                                .finalize("cpu"))
    assert auto.mode == "dynamic"       # 342 candidate pairs > 8 x 38


@gpu
def test_dynamic_substep_repeats_bit_for_bit_on_gpu():
    """On the card: two runs of a dynamic-pair XPBD substep of the pile
    (top-k and SAP) from one state equal bit for bit, and the per-call sum
    repeats bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    m = pile_scene(nt, worlds=8).finalize("cuda")
    solver = nt.SolverXPBD(m, iterations=4)
    for bp in ("topk", "sap"):
        pipe = nt.CollisionPipeline(m, mode="dynamic",
                                    dynamic_pair_budget=8 * 16 * 8,
                                    broad_phase=bp)
        s = m.state()
        for _ in range(20):
            s = solver.step(s, None, None, pipe.collide(s), 1 / 120)
        a = solver.step(s, None, None, pipe.collide(s), 1 / 120)
        b = solver.step(s, None, None, pipe.collide(s), 1 / 120)
        assert torch.equal(a.body_q, b.body_q) and torch.equal(
            a.body_qd, b.body_qd), bp
    g = torch.Generator(device="cuda").manual_seed(0)
    dst = torch.randint(-1, 1000, (200000,), device="cuda", generator=g)
    terms = torch.randn(200000, 7, device="cuda", generator=g)
    s = DynamicOrderSum(dst, 1000)
    assert torch.equal(s(terms), DynamicOrderSum(dst, 1000)(terms))
