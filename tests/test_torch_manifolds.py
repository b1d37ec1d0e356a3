"""Persistent contact manifolds in the port against the JAX package on the
CPU: ``CollisionPipeline(persistent_manifolds=True)`` over several frames
(the keep rule's anchors, points and depths, static and dynamic-pair
mode), ``match_contacts`` and the module-level ``collide``, the bridge's
counters and anchors, and two scenes the generalized solvers run on
persistent Contacts: example_peg_insertion.py under ``SolverMuJoCo`` and
example_kamino_mass_ratio.py under ``SolverKamino``, port against JAX for
a few substeps. On a CUDA card: a peg substep twice, bit for bit.

Tolerances: masks and shape indices exactly; points, normals, depths and
anchors 1e-5 (float32 transform chains); ``step`` body_q atol 2e-4,
body_qd 5e-3 (tests/test_batched_step.py:69-75).

    python -m pytest -o addopts="" --noconftest -m gpu tests/test_torch_manifolds.py
"""

import numpy as np
import pytest
import torch

import newton_tpu_torch as nt
from newton_tpu_torch.sim.collide import collide, match_contacts

torch.set_num_threads(1)

ATOL = 1e-5
QTOL, QDTOL = 2e-4, 5e-3
ANCHORS = ("manifold:a0", "manifold:a1", "manifold:n0")
PEG, CLEAR, DEPTH = 0.05, 0.001, 0.12       # example_peg_insertion.py
H = 0.1                                     # example_kamino_mass_ratio.py

gpu = pytest.mark.gpu


def peg_scene(lib, n=1):
    """example_peg_insertion.py: a square peg (half-width 0.05) 1.1 mm
    off-centre and turned 0.005 rad over a four-wall socket with 1 mm
    clearance a side, mu 0.2, on a ground plane; n worlds."""
    sub = lib.ModelBuilder(gravity=-9.81)
    cfg = sub.default_shape_cfg.copy()
    cfg.mu = 0.2
    w, t = PEG + CLEAR, 0.02
    for dx, dy, hx, hy in ((w + t, 0.0, t, w + 2 * t),
                           (-(w + t), 0.0, t, w + 2 * t),
                           (0.0, w + t, w, t), (0.0, -(w + t), w, t)):
        sub.add_shape_box(-1, xform=[dx, dy, DEPTH, 0, 0, 0, 1], hx=hx,
                          hy=hy, hz=DEPTH, cfg=cfg)
    yaw = 0.005
    q = [0.0, 0.0, float(np.sin(yaw / 2)), float(np.cos(yaw / 2))]
    peg = sub.add_body(xform=[0.0008, -0.0006, 2 * DEPTH + 0.09] + q,
                       key="peg")
    sub.add_shape_box(peg, hx=PEG, hy=PEG, hz=0.1, cfg=cfg)
    sub.add_joint_free(peg)
    sub.add_ground_plane()
    if n == 1:
        return sub
    b = lib.ModelBuilder(gravity=-9.81)
    b.replicate(sub, n)
    return b


def mass_ratio_scene(lib, n=1):
    """example_kamino_mass_ratio.py: an 800 kg block (density 1e5) resting
    on a 0.8 kg box (density 100), both of half-size 0.1, on a ground
    plane; n worlds."""
    sub = lib.ModelBuilder(gravity=-9.81)
    light = sub.default_shape_cfg.copy()
    light.density = 100.0
    heavy = sub.default_shape_cfg.copy()
    heavy.density = 100000.0
    lb = sub.add_body(xform=[0, 0, H, 0, 0, 0, 1], key="light")
    sub.add_shape_box(lb, hx=H, hy=H, hz=H, cfg=light)
    sub.add_joint_free(lb)
    hb = sub.add_body(xform=[0, 0, 3 * H * 1.003, 0, 0, 0, 1], key="heavy")
    sub.add_shape_box(hb, hx=H, hy=H, hz=H, cfg=heavy)
    sub.add_joint_free(hb)
    sub.add_ground_plane()
    if n == 1:
        return sub
    b = lib.ModelBuilder(gravity=-9.81)
    b.replicate(sub, n)
    return b


def _assert_contacts(got, ref, label=""):
    for name in ("rigid_contact_mask", "rigid_contact_shape0",
                 "rigid_contact_shape1"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=label + name)
    mask = np.asarray(ref.rigid_contact_mask)
    for name in ("rigid_contact_position", "rigid_contact_normal",
                 "rigid_contact_depth"):
        np.testing.assert_allclose(getattr(got, name).numpy()[mask],
                                   np.asarray(getattr(ref, name))[mask],
                                   atol=ATOL, err_msg=label + name)
    for name in ANCHORS:
        np.testing.assert_allclose(got.custom[name].numpy()[mask],
                                   np.asarray(ref.custom[name])[mask],
                                   atol=ATOL, err_msg=label + name)


def _run(jsolver, jpipe, tsolver, tpipe, jm, tm, substeps, dt, check):
    """``substeps`` substeps of ``collide(s, prev=c)`` then ``step`` in both
    packages from the model's state; ``check(k, jst, tst, jc, tc)`` after
    each."""
    import jax
    jst = jsolver.init_state(jm.state())
    tst = tsolver.init_state(tm.state())
    jc, tc = jpipe.contacts(), tpipe.contacts()

    @jax.jit
    def step(s, c):
        c = jpipe.collide(s, prev=c)
        return jsolver.step(s, None, None, c, dt), c
    for k in range(substeps):
        jst, jc = step(jst, jc)
        tc = tpipe.collide(tst, prev=tc)
        tst = tsolver.step(tst, None, None, tc, dt)
        check(k, jst, tst, jc, tc)
    return jst, tst, jc, tc


def _close_states(k, jst, tst):
    for name, tol in (("body_q", QTOL), ("body_qd", QDTOL),
                      ("joint_q", QTOL), ("joint_qd", QDTOL)):
        np.testing.assert_allclose(getattr(tst, name).numpy(),
                                   np.asarray(getattr(jst, name)), atol=tol,
                                   rtol=tol, err_msg=f"substep {k} {name}")


# ----------------------------------------------------------------------
# the keep rule
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["static", "dynamic"])
def test_persistence_over_frames_matches_jax(mode):
    """``_apply_persistence`` over eight frames of a sliding, sinking box
    pair and the peg's wall contacts (in static and dynamic-pair mode):
    each frame's Contacts, with ``prev`` the last frame's, equal the JAX
    pipeline's: which slots keep their anchored geometry (points from the
    cached anchors, depth from their gap) and the new anchors a0, a1, n0;
    some slots keep and some are refreshed."""
    import newton_tpu as jt
    from newton_tpu.sim.collide import CollisionPipeline as JPipe

    def scene(lib):
        b = peg_scene(lib)
        box = b.add_body(xform=[0.5, 0, 0.099, 0, 0, 0, 1])
        b.add_shape_box(box, hx=0.1, hy=0.1, hz=0.1)
        b.add_joint_free(box)
        top = b.add_body(xform=[0.52, 0.01, 0.297, 0, 0, 0.02, 0.9998])
        b.add_shape_box(top, hx=0.1, hy=0.08, hz=0.1)
        b.add_joint_free(top)
        return b
    jm, tm = scene(jt).finalize(), scene(nt).finalize("cpu")
    kw = dict(persistent_manifolds=True, mode=mode)
    if mode == "dynamic":
        kw["dynamic_pair_budget"] = 16
    jp, tp = JPipe(jm, **kw), nt.CollisionPipeline(tm, **kw)
    jc, tc = jp.contacts(), tp.contacts()
    assert set(tc.custom) == set(ANCHORS)
    q0 = np.asarray(jm.state().body_q).copy()
    q0[0, 2] = DEPTH + 0.1                     # the peg inside the socket
    kept_any = refreshed_any = False
    for f in range(8):
        q = q0.copy()
        q[:, 0] += 0.0004 * f * np.array([1, 1, -1])    # slide
        q[:, 2] -= 0.0003 * f                            # sink
        if f == 5:
            q[2, 0] += 0.02                  # a slide beyond the tolerance
        jc_new = jp.collide(jm.state().replace(body_q=q), prev=jc)
        ts = tm.state()
        ts.body_q = torch.as_tensor(q)
        tc_new = tp.collide(ts, prev=tc)
        _assert_contacts(tc_new, jc_new, f"frame {f}: ")
        if f:
            same = (np.asarray(jc_new.custom["manifold:a0"])
                    == np.asarray(jc.custom["manifold:a0"])).all(-1)
            act = np.asarray(jc_new.rigid_contact_mask)
            kept_any |= bool((same & act).any())
            refreshed_any |= bool((~same & act).any())
        jc, tc = jc_new, tc_new
    assert kept_any and refreshed_any


def test_match_contacts_and_collide():
    """``match_contacts`` gives the JAX package's (matched, new, broken)
    masks on two frames; the module-level ``collide`` equals the
    pipeline's; ``contacts()`` carries zero anchors; the bridge carries
    the overflow counters and the anchors both ways."""
    import newton_tpu as jt
    from newton_tpu.sim.collide import CollisionPipeline as JPipe
    from newton_tpu.sim.collide import match_contacts as j_match
    from newton_tpu_torch.utils import bridge
    jm, tm = peg_scene(jt).finalize(), peg_scene(nt).finalize("cpu")
    jp = JPipe(jm, persistent_manifolds=True)
    tp = nt.CollisionPipeline(tm, persistent_manifolds=True)
    frames = []
    for dz in (0.0, -0.245):
        q = np.asarray(jm.state().body_q).copy()
        q[0, 2] += dz
        ts = tm.state()
        ts.body_q = torch.as_tensor(q)
        frames.append((jp.collide(jm.state().replace(body_q=q)),
                       tp.collide(ts), ts))
    (j0, t0, _), (j1, t1, ts1) = frames
    for a, b in zip(match_contacts(t0, t1), j_match(j0, j1)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert match_contacts(t0, t1)[1].any()
    one = collide(tm, ts1)
    plain = nt.CollisionPipeline(tm).collide(ts1)
    for name in ("rigid_contact_mask", "rigid_contact_depth"):
        assert torch.equal(getattr(one, name), getattr(plain, name))
    empty = tp.contacts()
    assert not empty.rigid_contact_mask.any()
    assert all(not v.any() for v in empty.custom.values())
    d = bridge.contacts_to_numpy(t1)
    assert set(d["custom"]) == set(ANCHORS)
    back = bridge.contacts_from_numpy(d, "cpu")
    for name in ANCHORS:
        assert torch.equal(back.custom[name], t1.custom[name])
    assert int(back.broad_phase_dropped) == 0
    jd = {n: np.asarray(getattr(j1, n)) for n in
          bridge.CONTACT_FIELDS + bridge.CONTACT_COUNTERS}
    jd["custom"] = {k: np.asarray(v) for k, v in j1.custom.items()}
    _assert_contacts(bridge.contacts_from_numpy(jd, "cpu"), j1)


# ----------------------------------------------------------------------
# the generalized solvers on persistent Contacts
# ----------------------------------------------------------------------
def test_peg_insertion_matches_jax():
    """example_peg_insertion.py: SolverMuJoCo(iterations=30,
    warm_start=False, contact_cap=0), dt 1/480, ``collide(s, prev=c)``:
    40 substeps of the port against the JAX package's, every substep
    within 2e-4 / 5e-3 and every Contacts slot for slot; the peg reaches
    the walls (lateral and plane contacts active)."""
    import newton_tpu as jt
    from newton_tpu.sim.collide import CollisionPipeline as JPipe
    from newton_tpu.solvers import SolverMuJoCo as JMuJoCo
    jm, tm = peg_scene(jt).finalize(), peg_scene(nt).finalize("cpu")
    kw = dict(iterations=30, warm_start=False, contact_cap=0)
    seen = []

    def check(k, jst, tst, jc, tc):
        _close_states(k, jst, tst)
        _assert_contacts(tc, jc, f"substep {k}: ")
        seen.append(int(tc.rigid_contact_mask.sum()))
    _run(JMuJoCo(jm, **kw), JPipe(jm, persistent_manifolds=True),
         nt.SolverMuJoCo(tm, **kw),
         nt.CollisionPipeline(tm, persistent_manifolds=True), jm, tm, 40,
         1.0 / 480.0, check)
    assert max(seen) > 0


def test_kamino_mass_ratio_matches_jax():
    """example_kamino_mass_ratio.py: SolverKamino(iterations=32,
    contact_cap=0), dt 1/240, persistent manifolds: 12 substeps of the
    port against the JAX package's within 2e-4 / 5e-3, both boxes
    resting (light z 0.1 +- 0.01, heavy 0.3 +- 0.012)."""
    import newton_tpu as jt
    from newton_tpu.sim.collide import CollisionPipeline as JPipe
    from newton_tpu.solvers import SolverKamino as JKamino
    jm = mass_ratio_scene(jt).finalize()
    tm = mass_ratio_scene(nt).finalize("cpu")
    kw = dict(iterations=32, contact_cap=0)
    _, tst, _, _ = _run(
        JKamino(jm, **kw), JPipe(jm, persistent_manifolds=True),
        nt.SolverKamino(tm, **kw),
        nt.CollisionPipeline(tm, persistent_manifolds=True), jm, tm, 12,
        1.0 / 240.0, lambda k, js, ts, jc, tc: _close_states(k, js, ts))
    z = tst.body_q.numpy()[:, 2]
    assert abs(z[0] - H) < 0.01 and abs(z[1] - 3 * H) < 0.012, z


def test_replicated_peg_matches_one_world():
    """The peg x 3 through ``replicate`` under persistence: every world's
    substeps equal the one-world model's (static slots, one group of
    three rows)."""
    m1, m3 = peg_scene(nt).finalize("cpu"), peg_scene(nt, 3).finalize("cpu")
    kw = dict(iterations=30, warm_start=False, contact_cap=0)
    out = []
    for m in (m1, m3):
        pipe = nt.CollisionPipeline(m, persistent_manifolds=True)
        solver = nt.SolverMuJoCo(m, **kw)
        s, c = solver.init_state(m.state()), pipe.contacts()
        for _ in range(30):
            c = pipe.collide(s, prev=c)
            s = solver.step(s, None, None, c, 1.0 / 480.0)
        out.append(s.body_q)
    for w in range(3):
        np.testing.assert_allclose(out[1][w].numpy(), out[0][0].numpy(),
                                   atol=1e-6)


@gpu
def test_peg_substep_repeats_bit_for_bit_on_gpu():
    """On the card: the peg x 64 under persistence, two runs of a substep
    (collide with prev, then step) from one state equal bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    m = peg_scene(nt, 64).finalize("cuda")
    pipe = nt.CollisionPipeline(m, persistent_manifolds=True)
    solver = nt.SolverMuJoCo(m, iterations=30, warm_start=False,
                             contact_cap=0)
    s, c = solver.init_state(m.state()), pipe.contacts()
    for _ in range(40):
        c = pipe.collide(s, prev=c)
        s = solver.step(s, None, None, c, 1.0 / 480.0)

    def sub():
        c2 = pipe.collide(s, prev=c)
        return solver.step(s, None, None, c2, 1.0 / 480.0), c2
    (a, ca), (b, cb) = sub(), sub()
    assert torch.equal(a.body_q, b.body_q)
    assert torch.equal(ca.custom["manifold:a0"], cb.custom["manifold:a0"])
