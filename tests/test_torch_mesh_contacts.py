"""Parity of the port's mesh-kind contacts with the JAX package's
``CollisionPipeline.collide``: every static mesh class (the two-sided
mesh-primitive class on a heightfield, a box pad and a texture-baked
torus; mesh-mesh; the one-sided plane class; hull-hull and hull-box MPR)
on a flat state and on a batched one, hydroelastic on and off (the
stiffness of every slot too), and the dynamic-pair kinds (plane-mesh,
mesh-primitive, mesh-mesh, plane-hull, hull support pairs, with SAP).

Contacts agree in the masks, in the drop counters exactly, and in every
active slot's depth, point and stiffness to 1e-5: the reference holds
them steady at these poses (off grid-cell faces and the MPR's ties).
Normals agree to 1e-4: a normal read from a baked grid is a central
difference over 2 eps = 2e-3, so one float32 ulp of a distance near 0.5
moves it by ~3e-5 (the JAX package's jitted and eager collides differ
that much). The scenes turn every body by a small random rotation so
that no support direction ties."""

import os
import sys
import warnings

import numpy as np
import pytest
import torch

import newton_tpu_torch as nt

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke as cs  # noqa: E402  (the scenes of phases 49-51)

torch.set_num_threads(1)
FIELDS = ("rigid_contact_depth", "rigid_contact_position",
          "rigid_contact_normal")


def _shift(bq, dz, dxy=0.0, seed=1):
    bq = bq.copy()
    bq[..., 2] -= dz
    bq[..., :2] += dxy * np.random.RandomState(seed).randn(
        *bq.shape[:-1], 2)
    return bq


def _compare(jc, tc, hydro=False, atol=1e-5):
    m = np.asarray(jc.rigid_contact_mask)
    np.testing.assert_array_equal(tc.rigid_contact_mask.numpy(), m)
    assert m.any()
    for name in FIELDS + (("rigid_contact_stiffness",) if hydro else ()):
        a = np.asarray(getattr(jc, name))
        b = getattr(tc, name).numpy()
        tol = 1e-4 if name == "rigid_contact_normal" else atol
        np.testing.assert_allclose(b[m], a[m], atol=tol, rtol=tol,
                                   err_msg=name)
    for name in ("rigid_contact_shape0", "rigid_contact_shape1"):
        np.testing.assert_array_equal(
            getattr(tc, name).numpy()[m], np.asarray(getattr(jc, name))[m])
    np.testing.assert_array_equal(tc.mesh_samples_dropped.numpy(),
                                  np.asarray(jc.mesh_samples_dropped))


def _scene_pair(scene, n):
    import newton_tpu as jt
    return scene(jt, n).finalize(), scene(nt, n).finalize("cpu")


def _turned(rng, scale=0.06):
    q = np.r_[scale * rng.randn(3), 1.0]
    return q / np.linalg.norm(q)


def zoo_scene(lib, n=1):
    """Every static mesh class in one world, each cluster in its own
    collision group: a capsule on a heightfield (two-sided
    mesh-primitive), box meshes on the ground (one-sided plane class), on
    each other (mesh-mesh) and under a sphere (two-sided), a box mesh on
    a static box pad (two-sided), hulls on a hull and on a box (MPR), a
    hull on the ground, and a texture-baked torus (res 48) pressed on a
    capsule shaft; every body turned a little."""
    import importlib
    terrain = importlib.import_module(lib.__name__ + ".geometry.terrain")
    rng = np.random.RandomState(3)
    b = lib.ModelBuilder()

    def cfg(group, **kw):
        c = b.default_shape_cfg.copy()
        c.collision_group = group
        for k, v in kw.items():
            setattr(c, k, v)
        return c

    def body(x, y, z):
        i = b.add_body(xform=[x, y, z, *_turned(rng)])
        b.add_joint_free(i)
        return i
    b.add_shape_heightfield(-1, xform=[5.0, 0, 0, 0, 0, 0, 1], cfg=cfg(1),
                            heightfield=terrain.generate_fractal_terrain(
                                nx=10, ny=10, size_x=2.0, size_y=2.0,
                                amplitude=0.1, seed=2))
    b.add_shape_capsule(body(5.0, 0.0, 0.1), radius=0.08, half_height=0.3,
                        axis=0, cfg=cfg(1))
    mesh = cs.box_mesh(lib, 0.2)
    b.add_shape_mesh(body(0.0, 0.0, 0.19), mesh=mesh, cfg=cfg(2))
    b.add_shape_mesh(body(0.05, 0.0, 0.58), mesh=mesh, cfg=cfg(2))
    b.add_shape_sphere(body(0.0, 0.0, 0.96), radius=0.2, cfg=cfg(2))
    b.add_shape_box(-1, xform=[0, 3.0, -0.1, 0, 0, 0, 1], hx=0.5, hy=0.5,
                    hz=0.1, cfg=cfg(3))
    b.add_shape_mesh(body(0.0, 3.0, 0.18), mesh=mesh, cfg=cfg(3))
    hull = cs.box_mesh(lib, 0.15)
    b.add_shape_convex_hull(body(2.0, 0.0, 0.14), mesh=hull, cfg=cfg(4))
    b.add_shape_convex_hull(body(2.02, 0.0, 0.43), mesh=hull, cfg=cfg(4))
    b.add_shape_box(body(2.0, 0.29, 0.14), hx=0.15, hy=0.15, hz=0.15,
                    cfg=cfg(4))
    b.add_shape_capsule(-1, xform=[-3.0, 0, 0.55, 0, 0, 0, 1], radius=0.1,
                        half_height=0.45, cfg=cfg(5))
    nut = b.add_body(xform=[-2.95, 0.0, 0.55, *_turned(rng, 0.1)])
    b.add_joint_free(nut)
    b.add_shape_mesh(nut, mesh=cs.torus_mesh(lib), cfg=cfg(
        5, sdf_max_resolution=48))
    b.add_shape_plane(-1, cfg=cfg(-1))
    return cs.replicated(lib, b, n)


_STATIC = {
    # name: (scene, hydroelastic, drop, scene kwargs)
    "zoo": (zoo_scene, False, 0.0),
    "mesh_stack_hydro": (cs.mesh_stack_scene, True, 0.03),
    "pad_hydro": (cs.compliant_pad_scene, True, 0.06),
}


@pytest.fixture(scope="module")
def jax_collide():
    import jax
    from newton_tpu.sim.collide import CollisionPipeline as JP

    def make(model, **kw):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return JP(model, **kw)
    return make, jax


@pytest.mark.parametrize("case", list(_STATIC))
def test_static_classes_flat(case, jax_collide):
    make, jax = jax_collide
    scene, hydro, dz = _STATIC[case]
    jm, tm = _scene_pair(scene, 1)
    bq = _shift(np.asarray(jm.body_q), dz)
    jp = make(jm, hydroelastic=hydro)
    jc = jax.jit(jp.collide)(jm.state().replace(body_q=jm.body_q.at[:].set(bq)))
    pipe = nt.CollisionPipeline(tm, hydroelastic=hydro)
    ts = tm.state()
    ts.body_q = torch.as_tensor(bq, dtype=torch.float32)
    tc = pipe.collide(ts)
    _compare(jc, tc, hydro)
    assert (tc.rigid_contact_stiffness is not None) == hydro
    if case == "zoo":
        # every class kind, and a contact in every cluster
        assert {(pc.kind, pc.two_sided) for pc in pipe.mesh_classes} == {
            ("cc", False), ("mesh", False), ("mesh", True)}
        worlds = tm.shape_body.numpy()
        touched = tc.rigid_contact_shape0[tc.rigid_contact_mask].numpy()
        assert len(set(worlds[touched].tolist())) >= 6


@pytest.mark.parametrize("case", ["mesh_stack_hydro", "terrain"])
def test_static_classes_batched(case, jax_collide):
    """A batched (W, B, 7) state of a one-world model against the JAX
    collide vmapped over the envs."""
    make, jax = jax_collide
    scene, hydro, dz, dxy = ((cs.mesh_stack_scene, True, 0.03, 0.0)
                             if case == "mesh_stack_hydro" else
                             (cs.terrain_ant_scene, False, 0.55, 0.3))
    jm, tm = _scene_pair(scene, 1)
    W = 3
    bq = np.stack([_shift(np.asarray(jm.body_q), dz * (0.6 + 0.3 * w),
                          dxy, seed=w) for w in range(W)])
    jp = make(jm, hydroelastic=hydro)
    base = jm.state()
    jc = jax.jit(jax.vmap(lambda q: jp.collide(base.replace(body_q=q))))(bq)
    ts = nt.batch_state(tm.state(), W)
    ts.body_q = torch.as_tensor(bq, dtype=torch.float32)
    tc = nt.CollisionPipeline(tm, hydroelastic=hydro).collide(ts)
    assert tc.rigid_contact_mask.shape[0] == W
    _compare(jc, tc, hydro)


def _dyn_scene(lib):
    """One world with every dynamic-pair kind, each cluster in its own
    collision group: box meshes on the ground and on each other under a
    sphere (plane-mesh, mesh-mesh, mesh-primitive), hulls on the ground
    and on each other (plane-hull, hull support), a capsule on a
    heightfield; each body turned a little."""
    import importlib
    terrain = importlib.import_module(lib.__name__ + ".geometry.terrain")
    rng = np.random.RandomState(7)
    b = lib.ModelBuilder()

    def cfg(group):
        c = b.default_shape_cfg.copy()
        c.collision_group = group
        return c

    def body(x, y, z):
        i = b.add_body(xform=[x, y, z, *_turned(rng)])
        b.add_joint_free(i)
        return i
    mesh = cs.box_mesh(lib, 0.2)
    b.add_shape_mesh(body(0.0, 0.0, 0.19), mesh=mesh, cfg=cfg(1))
    b.add_shape_mesh(body(0.05, 0.0, 0.58), mesh=mesh, cfg=cfg(1))
    b.add_shape_sphere(body(0.0, 0.0, 0.96), radius=0.2, cfg=cfg(1))
    hull = cs.box_mesh(lib, 0.15)
    b.add_shape_convex_hull(body(2.0, 0.0, 0.14), mesh=hull, cfg=cfg(2))
    b.add_shape_convex_hull(body(2.02, 0.0, 0.43), mesh=hull, cfg=cfg(2))
    b.add_shape_heightfield(-1, xform=[5.0, 0, 0, 0, 0, 0, 1], cfg=cfg(3),
                            heightfield=terrain.generate_fractal_terrain(
                                nx=10, ny=10, size_x=2.0, size_y=2.0,
                                amplitude=0.1, seed=2))
    b.add_shape_capsule(body(5.0, 0.0, 0.1), radius=0.08, half_height=0.3,
                        axis=0, cfg=cfg(3))
    b.add_shape_plane(-1, cfg=cfg(-1))
    return b


def test_dynamic_kinds(jax_collide):
    """The dynamic kinds with the SAP broad phase (its mesh-ness
    orientation of mesh-primitive pairs included), the slot layout and
    the drop counters as the JAX package's."""
    make, jax = jax_collide
    jm, tm = _dyn_scene(__import__("newton_tpu")).finalize(), \
        _dyn_scene(nt).finalize("cpu")
    kw = dict(mode="dynamic", dynamic_pair_budget=16, broad_phase="sap",
              sap_window=4)
    jp = make(jm, **kw)
    jc = jax.jit(jp.collide)(jm.state())
    pipe = nt.CollisionPipeline(tm, **kw)
    tc = pipe.collide(tm.state())
    assert {pc.kind for pc in pipe.classes} == {
        "plane_mesh", "mesh_prim", "mesh_mesh", "plane_convex", "hull",
        "prim"}
    assert [pc.cap * pc.k for pc in pipe.classes] == [
        pc.cap * pc.slots for pc in jp.classes]
    _compare(jc, tc)
    assert int(tc.broad_phase_dropped) == int(jc.broad_phase_dropped)


# ----------------------------------------------------------------------
# reference defects (ROADMAP C.28-C.31), pinned
# ----------------------------------------------------------------------
def test_heightfield_pairs_take_the_default_slots():
    """C.28: the slot table lists heightfield pairs as (HFIELD, other),
    but pair_slot_count looks up (lower, higher) type, and HFIELD (9) is
    above sphere, box, capsule and mesh: every heightfield pair gets the
    default 4 slots, in both packages."""
    from newton_tpu.geometry import narrow_phase as j_np
    from newton_tpu_torch.geometry import narrow_phase as t_np
    G = nt.GeoType
    for t in (G.SPHERE, G.BOX, G.CAPSULE, G.MESH):
        assert t_np.pair_slot_count(int(G.HFIELD), int(t)) == 4 == \
            j_np.pair_slot_count(int(G.HFIELD), int(t))
    assert t_np._SLOTS[(int(G.HFIELD), int(G.CAPSULE))] == 2


def _hull_sphere(lib):
    b = lib.ModelBuilder()
    h = b.add_body(xform=[0, 0, 0.14, 0, 0, 0, 1])
    b.add_shape_convex_hull(h, mesh=cs.box_mesh(lib, 0.15))
    b.add_joint_free(h)
    s = b.add_body(xform=[0, 0, 0.44, 0, 0, 0, 1])
    b.add_shape_sphere(s, radius=0.16)
    b.add_joint_free(s)
    return b


def test_one_slot_two_sided_class(jax_collide):
    """C.29: a hull-sphere pair has 1 slot and a two-sided class (the
    hull has a bake); the JAX package gives its hull's side 1 // 2 = 0
    slots and raises stacking none. The port gives that side none and
    the sphere's samples in the hull's SDF the slot: 0.01 m apart."""
    import newton_tpu as jt
    make, _ = jax_collide
    jm = _hull_sphere(jt).finalize()
    with pytest.raises(ValueError, match="at least one array"):
        make(jm).collide(jm.state())
    tm = _hull_sphere(nt).finalize("cpu")
    c = nt.CollisionPipeline(tm).collide(tm.state())
    assert c.rigid_contact_mask.tolist() == [True]
    assert abs(float(c.rigid_contact_depth[0]) - 0.01) < 1e-4


def test_sdf_shape_pairs_are_skipped():
    """C.30: a shape given by its SDF grid (``add_shape_sdf``) gets no
    contact class in either mode; its pairs are skipped with a warning,
    as in the JAX package."""
    sdf = nt.SDF(np.zeros((4, 4, 4), np.float32), -np.ones(3), np.ones(3))
    b = nt.ModelBuilder()
    b.add_shape_sdf(-1, sdf=sdf)
    body = b.add_body(xform=[0, 0, 0.5, 0, 0, 0, 1])
    b.add_shape_sphere(body, radius=0.1)
    b.add_joint_free(body)
    m = b.finalize("cpu")
    assert m.structure.shape_sdf_id[0] == 0
    for mode in ("static", "dynamic"):
        with pytest.warns(UserWarning, match="unsupported"):
            pipe = nt.CollisionPipeline(m, mode=mode)
        assert not pipe.collide(m.state()).rigid_contact_mask.any()


def test_hydroelastic_in_dynamic_mode(jax_collide):
    """C.31: the JAX package's dynamic mode has no hydroelastic branch
    and ignores the flag; the port raises instead of computing rigid
    contacts under a hydroelastic name."""
    import newton_tpu as jt
    make, _ = jax_collide
    jp = make(cs.mesh_stack_scene(jt, 1).finalize(), hydroelastic=True,
              mode="dynamic")
    assert jp.hydroelastic and jp.mode == "dynamic"
    with pytest.raises(ValueError, match="static"):
        nt.CollisionPipeline(cs.mesh_stack_scene(nt, 1).finalize("cpu"),
                             hydroelastic=True, mode="dynamic")
