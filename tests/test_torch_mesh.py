"""Parity of the port's mesh-kind host preparation and its device samplers
with the JAX package: the C++ SDF bake (against its numpy twin and the JAX
package's bake), the sparse texture bake and sampling, the dense grid
sampler and its gradient, mesh mass properties, hulls, and the mesh part
of ``finalize`` (sample points and areas, hull clouds, SDF and texture
pools, sample cell areas) and the bridge's new fields, bit for bit; the
contact reductions at 1e-6 with a tie case; the port's own SDF cache. The
GPU cases hold the samplers and the stable top-k on ties on the card
against the CPU."""

import os
import sys

import numpy as np
import pytest
import torch

import newton_tpu_torch as nt

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke as cs  # noqa: E402  (the scenes of phases 49-51)
from newton_tpu_torch.geometry import sdf as tsdf
from newton_tpu_torch.geometry import sdf_texture as ttex
from newton_tpu_torch.sim.model import MODEL_FLOAT_FIELDS, MODEL_INT_FIELDS
from newton_tpu_torch.utils import bridge

torch.set_num_threads(1)
gpu = pytest.mark.skipif(not torch.cuda.is_available(),
                         reason="needs a CUDA device")


def _box():
    return cs.box_mesh(nt, 0.3)


def _bumpy():
    """A closed, irregular mesh (a perturbed torus, few triangles)."""
    m = cs.torus_mesh(nt, R=0.3, r=0.12, nu=10, nv=6)
    rng = np.random.RandomState(0)
    return nt.Mesh(m.vertices + 0.01 * rng.randn(*m.vertices.shape),
                   m.indices)


# ----------------------------------------------------------------------
# bakes
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mesh", [_box, _bumpy])
def test_cpp_bake_matches_numpy_twin_and_jax(mesh):
    """The C++ bake equals the JAX package's bake bit for bit (the same
    source and flags) and its numpy twin to rounding (1e-6 of the
    extent), signs included at these sizes."""
    from newton_tpu.geometry.sdf import bake_mesh_sdf as j_bake
    m = mesh()
    got = tsdf.bake_mesh_sdf(m, resolution=14)
    twin = tsdf.bake_mesh_sdf(m, resolution=14, native=False)
    ref = j_bake(m, resolution=14)
    np.testing.assert_array_equal(got.data, ref.data)
    np.testing.assert_array_equal(got.lower, ref.lower)
    np.testing.assert_allclose(twin.data, got.data, atol=1e-6, rtol=0)


def test_cpp_build_failure_raises(tmp_path, monkeypatch):
    """A bake whose C++ build fails raises; nothing falls back."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tsdf, "_SRC", str(bad))
    monkeypatch.setattr(tsdf, "_BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(tsdf, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tsdf.bake_mesh_sdf(_box(), resolution=6)


def test_texture_bake_and_sampling_match_jax():
    """The sparse texture of a mesh equals the JAX bake bit for bit, and
    sampling it at random points (inside, near the surface and outside
    the box, fine and coarse blocks) agrees at 1e-6."""
    import jax.numpy as jnp
    from newton_tpu.geometry.sdf_texture import (
        bake_texture_sdf as j_bake, sample_texture_sdf as j_sample)
    m = _bumpy()
    t = ttex.bake_texture_sdf(m, resolution=48)
    j = j_bake(m, resolution=48)
    for name in ("block_index", "blocks", "block_scale", "block_offset",
                 "coarse", "lower", "upper"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name),
                                      err_msg=name)
    assert (t.block_index >= 0).any() and (t.block_index < 0).any()
    rng = np.random.RandomState(1)
    pts = rng.uniform(t.lower - 0.05, t.upper + 0.05, (400, 3)).astype(
        np.float32)
    f32 = np.float32
    ref = np.asarray(j_sample(
        jnp.asarray(j.block_index), jnp.asarray(j.blocks),
        jnp.asarray(j.block_scale), jnp.asarray(j.block_offset),
        jnp.asarray(j.coarse), jnp.asarray(j.lower, f32),
        jnp.asarray(j.upper, f32), jnp.asarray(pts)))
    T = torch.as_tensor
    got = ttex.sample_texture_sdf(
        T(t.block_index), T(t.blocks), T(t.block_scale), T(t.block_offset),
        T(t.coarse), T(t.lower.astype(f32)), T(t.upper.astype(f32)), T(pts))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)


def test_grid_sampler_and_gradient_match_jax():
    """Trilinear sampling of a baked grid and its central-difference
    gradient at random points, and the pooled form (each point naming
    its grid) against sampling each grid alone."""
    import jax.numpy as jnp
    from newton_tpu.geometry.sdf import (sample_sdf_grad as j_grad,
                                         sample_sdf_grid as j_grid)
    s = tsdf.bake_mesh_sdf(_bumpy(), resolution=12)
    rng = np.random.RandomState(2)
    pts = rng.uniform(s.lower - 0.05, s.upper + 0.05, (300, 3)).astype(
        np.float32)
    lo, hi = (np.asarray(x, np.float32) for x in (s.lower, s.upper))
    args = (jnp.asarray(s.data), jnp.asarray(lo), jnp.asarray(hi),
            jnp.asarray(pts))
    T = torch.as_tensor
    targs = (T(s.data), T(lo), T(hi), T(pts))
    np.testing.assert_allclose(tsdf.sample_sdf_grid(*targs).numpy(),
                               np.asarray(j_grid(*args)), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tsdf.sample_sdf_grad(*targs).numpy(),
                               np.asarray(j_grad(*args)), atol=1e-4, rtol=0)
    pool = torch.stack([T(s.data), -T(s.data)])
    gid = T(rng.randint(0, 2, 300))
    pooled = tsdf.sample_sdf_grid(pool, T(lo), T(hi), T(pts), gid)
    alone = tsdf.sample_sdf_grid(T(s.data), T(lo), T(hi), T(pts))
    torch.testing.assert_close(pooled, torch.where(gid == 0, alone, -alone),
                               atol=0, rtol=0)


def test_mesh_inertia_and_hull_match_jax():
    from newton_tpu.geometry.inertia import compute_mesh_inertia as j_inert
    from newton_tpu.sim.builder import _convex_hull_mesh as j_hull
    from newton_tpu_torch.geometry.inertia import compute_mesh_inertia
    from newton_tpu_torch.sim.mesh_prep import _convex_hull_mesh
    m = _bumpy()
    for solid in (True, False):
        got = compute_mesh_inertia(700.0, m.vertices, m.indices,
                                   is_solid=solid)
        ref = j_inert(700.0, m.vertices, m.indices, is_solid=solid)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    h, hj = _convex_hull_mesh(m), j_hull(m)
    np.testing.assert_array_equal(h.vertices, hj.vertices)
    np.testing.assert_array_equal(h.indices, hj.indices)


def test_sdf_cache_in_its_own_directory(tmp_path, monkeypatch):
    """A bake is stored under the port's cache directory (here tmp_path)
    and read back equal."""
    from newton_tpu_torch.geometry import sdf_cache
    monkeypatch.setenv("NEWTON_TPU_TORCH_SDF_CACHE_DIR", str(tmp_path))
    m = _box()
    a = sdf_cache.cached_bake_mesh_sdf(m, resolution=8)
    files = list(tmp_path.glob("*.npz"))
    assert len(files) == 1
    b = sdf_cache.cached_bake_mesh_sdf(m, resolution=8)
    np.testing.assert_array_equal(a.data, b.data)
    t = sdf_cache.cached_bake_texture_sdf(m, resolution=16)
    t2 = sdf_cache.cached_bake_texture_sdf(m, resolution=16)
    np.testing.assert_array_equal(t.blocks, t2.blocks)
    assert len(list(tmp_path.glob("*.npz"))) == 2


# ----------------------------------------------------------------------
# finalize and the bridge
# ----------------------------------------------------------------------
def _mixed(lib):
    """Every mesh kind in two worlds: a heightfield, a torus mesh with a
    texture bake (res 48) and a box mesh with a dense one, a hull, boxes,
    a capsule, a sphere and a scaled mesh, over a ground plane."""
    import importlib
    terrain = importlib.import_module(lib.__name__ + ".geometry.terrain")
    sub = lib.ModelBuilder()
    sub.add_shape_heightfield(-1, heightfield=terrain.generate_fractal_terrain(
        nx=12, ny=10, size_x=4.0, size_y=3.0, amplitude=0.2, seed=5))
    cfg = sub.default_shape_cfg.copy()
    cfg.sdf_max_resolution = 48
    cfg.kh = 3.0e5
    b0 = sub.add_body(xform=[0, 0, 1.0, 0, 0, 0, 1])
    sub.add_shape_mesh(b0, mesh=cs.torus_mesh(lib, nu=10, nv=6), cfg=cfg)
    sub.add_joint_free(b0)
    b1 = sub.add_body(xform=[1.0, 0, 1.0, 0, 0, 0, 1])
    sub.add_shape_mesh(b1, mesh=cs.box_mesh(lib, 0.2), scale=(1.0, 2.0, 0.5))
    sub.add_shape_box(b1, xform=[0, 0, 0.3, 0, 0, 0, 1], hx=0.1, hy=0.1,
                      hz=0.1)
    sub.add_joint_free(b1)
    b2 = sub.add_body(xform=[-1.0, 0, 1.0, 0, 0, 0, 1])
    sub.add_shape_convex_hull(b2, mesh=cs.box_mesh(lib, 0.15))
    sub.add_shape_capsule(b2, xform=[0, 0, 0.3, 0, 0, 0, 1], radius=0.05,
                          half_height=0.1)
    sub.add_joint_free(b2)
    b3 = sub.add_body(xform=[0, 1.0, 1.0, 0, 0, 0, 1])
    sub.add_shape_sphere(b3, radius=0.1)
    sub.add_joint_free(b3)
    sub.add_ground_plane()
    b = lib.ModelBuilder()
    b.replicate(sub, 2)
    return b


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    import newton_tpu as jt
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NEWTON_TPU_TORCH_SDF_CACHE_DIR",
                  str(tmp_path_factory.mktemp("sdf_cache")))
        yield _mixed(jt).finalize(), _mixed(nt).finalize("cpu")


def _jax_leaves(jm):
    leaves = {n: np.asarray(getattr(jm, n))
              for n in MODEL_FLOAT_FIELDS + MODEL_INT_FIELDS}
    leaves["custom"] = {}
    structure = {n: getattr(jm.structure, n) for n in bridge.STRUCTURE_FIELDS}
    structure["mjc_actuation"] = None
    return leaves, structure


_MESH_LEAVES = ("shape_sample_points", "shape_sample_areas", "sdf_grids",
                "sdf_lower", "sdf_upper", "sdf_tex_block_index",
                "sdf_tex_blocks", "sdf_tex_scale", "sdf_tex_offset",
                "sdf_tex_coarse", "sdf_tex_lower", "sdf_tex_upper",
                "shape_material_kh", "shape_collision_radius", "body_mass",
                "body_inertia", "body_com")
_MESH_STRUCTURE = ("shape_sdf_id", "shape_sdf_tex_id", "shape_hull_verts",
                   "shape_sample_cell_area", "candidate_pairs",
                   "candidate_pair_slots")


def test_finalize_mesh_arrays_equal_jax(mixed):
    """Samples, areas, pools, hulls, ids and cell areas: bit for bit."""
    jm, tm = mixed
    for name in _MESH_LEAVES:
        a, b = np.asarray(getattr(jm, name)), getattr(tm, name).numpy()
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    for name in _MESH_STRUCTURE:
        np.testing.assert_array_equal(getattr(tm.structure, name),
                                      getattr(jm.structure, name),
                                      err_msg=name)
    st = tm.structure
    assert (st.shape_sdf_tex_id >= 0).sum() == 2     # the tori: one bake
    assert tm.sdf_tex_block_index.shape[0] == 1
    assert tm.sdf_tex_blocks.dtype == torch.uint8
    # each world's field, box mesh and hull; one grid per field, one bake
    # for the two box meshes and one for the two hulls
    assert (st.shape_sdf_id >= 0).sum() == 6
    assert tm.sdf_grids.shape == (4, 24, 24, 24)


def test_bridge_carries_mesh_fields(mixed):
    """The JAX model through the bridge equals the port's own finalize in
    every mesh leaf (uint8 blocks kept) and structure field."""
    jm, tm = mixed
    bm = bridge.model_from_numpy(*_jax_leaves(jm), "cpu")
    for name in _MESH_LEAVES:
        assert torch.equal(getattr(bm, name), getattr(tm, name)), name
    for name in _MESH_STRUCTURE:
        np.testing.assert_array_equal(getattr(bm.structure, name),
                                      getattr(tm.structure, name))
    leaves, structure = bridge.model_to_numpy(tm)
    back = bridge.model_from_numpy(leaves, structure, "cpu")
    assert back.sdf_tex_blocks.dtype == torch.uint8
    assert torch.equal(back.sdf_tex_blocks, tm.sdf_tex_blocks)


# ----------------------------------------------------------------------
# contact reduction
# ----------------------------------------------------------------------
def _candidates(seed, n=5, K=24, ties=False):
    rng = np.random.RandomState(seed)
    pos = rng.randn(n, K, 3).astype(np.float32)
    nrm = rng.randn(n, K, 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    depth = (0.01 * rng.randn(n, K)).astype(np.float32)
    if ties:
        # a box lying flat: equal depths on a grid of equal normals, and
        # padded duplicate samples
        depth[:, :12] = 0.02
        nrm[:, :12] = [0, 0, 1]
        pos[:, 12:16] = pos[:, :4]
    active = depth > -0.005
    fmag = np.abs(rng.randn(n, K)).astype(np.float32)
    return pos, nrm, depth, active, fmag


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("k", [1, 4, 8])
def test_reduce_contact_set_matches_jax(ties, k):
    import jax.numpy as jnp
    from newton_tpu.geometry import contact_reduction as jcr
    from newton_tpu_torch.geometry import contact_reduction as tcr
    pos, nrm, depth, active, fmag = _candidates(k, ties=ties)
    J, T = jnp.asarray, torch.as_tensor
    ref = jcr.reduce_contact_set(J(pos), J(nrm), J(depth), k,
                                 active=J(active))
    got = tcr.reduce_contact_set(T(pos), T(nrm), T(depth), k,
                                 active=T(active))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=0)
    ref = jcr.reduce_contact_set_hydro(J(pos), J(nrm), J(depth), J(fmag), k,
                                       active=J(active))
    got = tcr.reduce_contact_set_hydro(T(pos), T(nrm), T(depth), T(fmag), k,
                                       active=T(active))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=1e-6)
    # the patch force is conserved
    np.testing.assert_allclose(got[3].sum(-1).numpy(),
                               np.where(active, fmag, 0).sum(-1), rtol=1e-5)


def test_top_k_ties_pick_lower_index():
    """The k deepest of equal depths are the first k samples, in order
    (lax.top_k's order), as the mesh classes' top-k path needs."""
    from newton_tpu_torch.sim.collide_mesh import _top
    pen = torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.3, 0.3]])
    v, i = _top(pen, 3)
    assert i.tolist() == [[1, 2, 4]]


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
@pytest.mark.gpu
@gpu
def test_samplers_on_card_match_cpu():
    s = tsdf.bake_mesh_sdf(_bumpy(), resolution=12)
    t = ttex.bake_texture_sdf(_bumpy(), resolution=24)
    rng = np.random.RandomState(3)
    pts = rng.uniform(s.lower, s.upper, (5000, 3)).astype(np.float32)
    lo, hi = (np.asarray(x, np.float32) for x in (s.lower, s.upper))
    tl, th = (np.asarray(x, np.float32) for x in (t.lower, t.upper))
    for dev in ("cpu", "cuda"):
        T = (lambda x, d=dev: torch.as_tensor(x, device=d))
        g = tsdf.sample_sdf_grad(T(s.data), T(lo), T(hi), T(pts))
        d = ttex.sample_texture_sdf(
            T(t.block_index), T(t.blocks), T(t.block_scale),
            T(t.block_offset), T(t.coarse), T(tl), T(th), T(pts))
        if dev == "cpu":
            ref = (g, d)
    torch.testing.assert_close(g.cpu(), ref[0], atol=1e-4, rtol=0)
    torch.testing.assert_close(d.cpu(), ref[1], atol=1e-6, rtol=0)


@pytest.mark.gpu
@gpu
def test_top_k_ties_on_card():
    from newton_tpu_torch.sim.collide_mesh import _top
    pen = torch.zeros(64, 32, device="cuda")
    pen[:, 5:] = 1.0
    v, i = _top(pen, 4)
    assert (i == torch.arange(5, 9, device="cuda")).all()
