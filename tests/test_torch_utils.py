"""The port's host-side utilities against the JAX package on the CPU:
``utils/checkpoint.py`` (save and load bit for bit, the digest, a
checkpoint the JAX package wrote), ``utils/validation.py`` (the same
reports on the same good and bad states; ``checkify_step``),
``utils/benchmark.py`` (the tracer, the timer and the benchmark harness:
structure and keys, tests/test_utils.py:110), the builder's ``color``,
``plot_articulation`` and ``request_*_attributes``, and
``parallel/envs.py``'s ``unbatch_env`` and ``vmap_step``.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import newton_tpu as jt
from newton_tpu.parallel import unbatch_env as j_unbatch_env
from newton_tpu.sim.articulation import eval_fk as j_eval_fk
from newton_tpu.utils import checkpoint as j_ckpt
from newton_tpu.utils import validation as j_val

import newton_tpu_torch as nt
from newton_tpu_torch.parallel import unbatch_env, vmap_step
from newton_tpu_torch.utils import benchmark, checkpoint, validation
from newton_tpu_torch.utils import bridge

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke as cs  # noqa: E402  (phase 59's scene)

torch.set_num_threads(1)

ANT_XML = os.path.join(nt.ASSET_DIR, "ant.xml")
ANT_USDA = os.path.join(nt.ASSET_DIR, "ant.usda")


def pendulum(lib):
    """tests/test_utils.py:19's pendulum with either package's builder."""
    b = lib.ModelBuilder()
    link = b.add_body(xform=[0.5, 0, 0, 0, 0, 0, 1])
    b.add_shape_box(link, hx=0.5, hy=0.05, hz=0.05)
    b.add_joint_revolute(parent=-1, child=link, axis="Y",
                         xform_c=[-0.5, 0, 0, 0, 0, 0, 1])
    return b


@pytest.fixture(scope="module")
def ant():
    """The USD ant on the CPU, a moved state with solver entries in
    ``custom``, in both packages."""
    tm = cs.usd_ant_scene(nt, ANT_USDA).finalize("cpu")
    jm = cs.usd_ant_scene(jt, ANT_USDA).finalize()
    rng = np.random.RandomState(0)
    q = (tm.joint_q0.numpy() + 0.1 * rng.randn(15)).astype(np.float32)
    qd = rng.randn(14).astype(np.float32)
    custom = {"mjc:act": rng.randn(8).astype(np.float32),
              "contact:lam:0": rng.randn(75).astype(np.float32)}
    ts = nt.eval_fk(tm, torch.as_tensor(q), torch.as_tensor(qd), tm.state())
    ts = ts.replace(custom={k: torch.as_tensor(v) for k, v in custom.items()})
    js = j_eval_fk(jm, jnp.asarray(q), jnp.asarray(qd), jm.state())
    js = js.replace(custom={k: jnp.asarray(v) for k, v in custom.items()})
    return tm, ts, jm, js


def assert_states_equal(a, b):
    for name, t in checkpoint.state_leaves(a):
        u = dict(checkpoint.state_leaves(b))[name]
        assert t.dtype == u.dtype and torch.equal(t, u), name
    assert sorted(a.custom) == sorted(b.custom)


# -- checkpoint -------------------------------------------------------------

def test_save_load_bit_exact(ant, tmp_path):
    """tests/test_utils.py:28 on the port: the ant's state with custom
    entries, and a batched state into model.state()'s layout."""
    tm, ts, _, _ = ant
    path = str(tmp_path / "state.npz")
    checkpoint.save_state(path, ts)
    back = checkpoint.load_state(path, tm.state())
    assert_states_equal(back, ts)
    assert checkpoint.state_digest(back) == checkpoint.state_digest(ts)
    sb = nt.batch_state(ts, 3)
    checkpoint.save_state(str(tmp_path / "batched"), sb)
    back = checkpoint.load_state(str(tmp_path / "batched"), tm.state())
    assert back.joint_q.shape == (3, 15)
    assert_states_equal(back, sb)


def test_load_restores_like_dtype_and_keys(ant, tmp_path):
    """load_state takes ``like``'s dtypes and names; a missing field
    raises naming it."""
    tm, ts, _, _ = ant
    path = str(tmp_path / "s.npz")
    checkpoint.save_state(path, ts.replace(joint_q=ts.joint_q.double()))
    assert checkpoint.load_state(path, tm.state()).joint_q.dtype \
        == torch.float32
    np.savez(path, body_q=ts.body_q.numpy())
    with pytest.raises(KeyError, match="body_qd"):
        checkpoint.load_state(path, tm.state())


@pytest.mark.parametrize("field", ["body_q", "body_qd", "joint_q",
                                   "joint_qd", "custom/mjc:act"])
def test_digest_changes_by_one_ulp(ant, field):
    """Moving one element of one field by one ulp changes the digest; so
    do a dtype and a shape that keep the bytes."""
    _, ts, _, _ = ant
    d0 = checkpoint.state_digest(ts)
    leaves = dict(checkpoint.state_leaves(ts))
    t = leaves[field].clone()
    t.view(-1)[1] = torch.nextafter(t.view(-1)[1], torch.tensor(np.inf))
    if field.startswith("custom/"):
        moved = ts.replace(custom={**ts.custom, field[7:]: t})
    else:
        moved = ts.replace(**{field: t})
    assert checkpoint.state_digest(moved) != d0
    assert checkpoint.state_digest(ts) == d0
    as_int = ts.replace(joint_q=ts.joint_q.view(torch.int32))
    assert checkpoint.state_digest(as_int) != d0
    flat = ts.replace(body_q=ts.body_q.reshape(-1))
    assert checkpoint.state_digest(flat) != d0


def test_loads_a_jax_checkpoint(ant, tmp_path):
    """A checkpoint written by the JAX package's save_state (positional
    leaves and a .tree file) loads into the port's State by the State's
    field order, custom entries by sorted key."""
    tm, ts, jm, js = ant
    path = str(tmp_path / "jax.npz")
    j_ckpt.save_state(path, js)
    assert os.path.exists(path + ".tree")
    back = checkpoint.load_state(path, ts)
    for name, t in checkpoint.state_leaves(back):
        key = name[7:] if name.startswith("custom/") else None
        ref = js.custom[key] if key else getattr(js, name)
        np.testing.assert_array_equal(t.numpy(), np.asarray(ref),
                                      err_msg=name)
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.load_state(path, tm.state())


# -- validation -------------------------------------------------------------

def _bad_states(ts, js):
    """(name, port state, JAX state) pairs: good, NaN in body_q, Inf in
    joint_qd and a custom entry, an unnormalized quaternion, a fast body."""
    def both(**kw):
        t = ts.replace(**{k: torch.as_tensor(v) for k, v in kw.items()
                          if k != "custom"})
        j = js.replace(**{k: jnp.asarray(v) for k, v in kw.items()
                          if k != "custom"})
        if "custom" in kw:
            t = t.replace(custom={**ts.custom, **{
                k: torch.as_tensor(v) for k, v in kw["custom"].items()}})
            j = j.replace(custom={**js.custom, **{
                k: jnp.asarray(v) for k, v in kw["custom"].items()}})
        return t, j
    bq = ts.body_q.numpy().copy()
    qd = ts.joint_qd.numpy().copy()
    act = ts.custom["mjc:act"].numpy().copy()
    nan_q = bq.copy()
    nan_q[3, 1] = np.nan
    inf_qd = qd.copy()
    inf_qd[2] = -np.inf
    inf_act = act.copy()
    inf_act[0] = np.inf
    long_q = bq.copy()
    long_q[0, 3:7] *= 1.5
    fast = ts.body_qd.numpy().copy()
    fast[5, 4] = 2e4
    return [("good", ts, js), ("nan body_q", *both(body_q=nan_q)),
            ("inf joint_qd and custom", *both(joint_qd=inf_qd,
                                               custom={"mjc:act": inf_act})),
            ("unnormalized", *both(body_q=long_q)),
            ("fast", *both(body_qd=fast))]


def test_validation_reports_match_jax(ant):
    """find_nan_members, find_nonfinite_members, check_state_valid and
    nan_sweep give the JAX package's reports on the same states."""
    _, ts, _, js = ant
    for name, t, j in _bad_states(ts, js):
        assert validation.find_nan_members(t) == \
            j_val.find_nan_members(j), name
        assert validation.find_nonfinite_members(t) == \
            j_val.find_nonfinite_members(j), name
        assert validation.check_state_valid(t) == \
            j_val.check_state_valid(j), name
        outcome = []
        for sweep, s in ((validation.nan_sweep, t), (j_val.nan_sweep, j)):
            try:
                sweep(s, context=name)
                outcome.append(None)
            except AssertionError as e:
                outcome.append(str(e))
        assert outcome[0] == outcome[1], name
    assert validation.find_nonfinite_members(ts) == []


def test_assert_np_equal():
    a = torch.tensor([1.0, 2.0])
    validation.assert_np_equal(a, np.array([1.0, 2.0]))
    validation.assert_np_equal(a, a + 1e-4, tol=1e-3)
    with pytest.raises(AssertionError):
        validation.assert_np_equal(a, a + 1e-4)


def test_checkify_step_raises_only_on_throw(ant):
    """The checked step returns (err, out) without raising; err.throw()
    raises on a non-finite output and nowhere else; a clean step's
    err.get() is None."""
    _, ts, _, _ = ant

    def step(s, poison):
        q = s.joint_q * 1.0
        if poison:
            q = q / torch.zeros_like(q)
        return s.replace(joint_q=q)
    checked = validation.checkify_step(step)
    err, out = checked(ts, True)
    assert isinstance(out, nt.State)
    assert not bool(torch.isfinite(out.joint_q).all())
    with pytest.raises(FloatingPointError, match="joint_q"):
        err.throw()
    err, out = checked(ts, False)
    assert err.get() is None
    err.throw()
    err, out = validation.checkify_step(lambda x: x * 2)(torch.ones(3))
    err.throw()


# -- benchmark --------------------------------------------------------------

def test_event_tracer_and_timer():
    """tests/test_utils.py:110 on the port, with nested and repeated
    scopes: the report lists each scope once, indented under its parent,
    with its count."""
    tr = benchmark.EventTracer(sync=True)
    with tr.scope("outer"):
        with tr.scope("inner"):
            pass
        with tr.scope("inner", result=torch.zeros(2)):
            pass
    with tr.scope("outer"):
        pass
    rep = tr.report()
    lines = rep.splitlines()
    assert len(lines) == 2
    assert lines[0].startswith("outer: ") and lines[0].endswith("x2")
    assert lines[1].startswith("  inner: ") and lines[1].endswith("x2")
    outer = tr.root["children"][0]
    assert outer["count"] == 2 and outer["elapsed"] >= \
        outer["children"][0]["elapsed"] >= 0
    with benchmark.ScopedTimer("t", print_=False) as t:
        pass
    assert t.elapsed >= 0


def test_event_scope_uses_the_global_tracer():
    calls = []

    @benchmark.event_scope
    def work(x):
        calls.append(x)
        return x + 1
    assert work(1) == 2
    tr = benchmark.EventTracer(sync=False)
    benchmark._GLOBAL_TRACER = tr
    try:
        assert work(2) == 3
    finally:
        benchmark._GLOBAL_TRACER = None
    assert calls == [1, 2]
    assert tr.root["children"][0]["name"].endswith("work")


def test_benchmark_step_and_run_benchmark(tmp_path):
    """benchmark_step returns (ms, state) after warmup + iters calls;
    run_benchmark the JAX package's keys, and a torch.profiler trace in
    profile_dir."""
    m = pendulum(nt).finalize("cpu")
    solver = nt.SolverXPBD(m, iterations=2)
    ctl = m.control()
    calls = []

    def frame(s):
        calls.append(1)
        return solver.step(s, None, ctl, None, 1 / 240)
    s0 = nt.eval_fk(m, torch.tensor([0.3]), torch.tensor([0.0]), m.state())
    ms, s = benchmark.benchmark_step(frame, s0, iters=4, warmup=2)
    assert ms > 0 and len(calls) == 6 and isinstance(s, nt.State)
    out = benchmark.run_benchmark(frame, s0, frames=3, substeps=1, worlds=1,
                                  dt=1 / 240, profile_dir=str(tmp_path))
    assert sorted(out) == ["ms_per_world_step", "rtf", "state",
                           "world_steps_per_s"]
    assert out["world_steps_per_s"] == pytest.approx(
        1e3 / out["ms_per_world_step"])
    assert os.path.getsize(tmp_path / "trace.json") > 0


# -- builder extras -----------------------------------------------------------

def test_color_matches_jax():
    """color() on a cloth grid (springs, triangles, bending edges) and on
    a tet mesh gives the JAX package's colours, each an independent set."""
    from newton_tpu_torch.sim.graph_coloring import validate_graph_coloring
    for make in (lambda b: b.add_cloth_grid(pos=(0, 0, 1), dim_x=6,
                                            dim_y=5, cell_x=0.1,
                                            cell_y=0.1, mass=0.1),
                 lambda b: b.add_soft_grid(pos=(0, 0, 1), rot=None,
                                           vel=(0, 0, 0), dim_x=3, dim_y=2,
                                           dim_z=2, cell_x=0.1, cell_y=0.1,
                                           cell_z=0.1)):
        tb, jb = nt.ModelBuilder(), jt.ModelBuilder()
        make(tb)
        make(jb)
        for bending in (True, False):
            got = tb.color(include_bending=bending)
            ref = jb.color(include_bending=bending)
            assert len(got) == len(ref) > 1
            for a, b in zip(got, ref):
                np.testing.assert_array_equal(a, b)
        edges = [(t[i], t[j]) for t in tb.tet_indices for i in range(4)
                 for j in range(i + 1, 4)] + [
            (a, b) for a, b, c in tb.tri_indices] + list(tb.spring_indices)
        assert validate_graph_coloring(np.asarray(edges), tb.color())


@pytest.mark.parametrize("source", ["mjcf", "usd"])
def test_plot_articulation_matches_jax(source):
    """The same text as the JAX package's on ant.xml and on ant.usda
    (whose free root's joint comes last and prints first)."""
    out = []
    for lib in (nt, jt):
        b = lib.ModelBuilder()
        if source == "mjcf":
            b.add_mjcf(ANT_XML)
        else:
            b.add_usd(ANT_USDA)
        out.append(b.plot_articulation())
    assert out[0] == out[1]
    lines = out[0].splitlines()
    assert len(lines) == 13 and "[FREE]" in lines[0]
    assert sum(line.startswith("      ") for line in lines) == 4


def test_requested_attributes_survive_replicate_and_add_builder():
    for lib in (nt, jt):
        sub = pendulum(lib)
        sub.request_state_attributes("body_qdd", "joint_qdd")
        sub.request_contact_attributes("force")
        sub.request_state_attributes("body_qdd")
        b = lib.ModelBuilder()
        b.replicate(sub, 3)
        assert b._requested_state_attrs == {"body_qdd", "joint_qdd"}
        assert b._requested_contact_attrs == {"force"}
        c = lib.ModelBuilder()
        c.request_contact_attributes("normal")
        c.add_builder(sub)
        assert c._requested_state_attrs == {"body_qdd", "joint_qdd"}
        assert c._requested_contact_attrs == {"force", "normal"}


# -- envs -------------------------------------------------------------------

def test_unbatch_env_inverts_batch_state(ant):
    """unbatch_env(batch_state(s, n), i) is s, for every i, bit for bit,
    and a copy; on a batched state of distinct envs it is the JAX
    package's unbatch_env."""
    tm, ts, jm, js = ant
    sb = nt.batch_state(ts, 3)
    for i in range(3):
        assert_states_equal(unbatch_env(sb, i), ts)
    one = unbatch_env(sb, 1)
    one.joint_q.add_(1.0)
    assert torch.equal(sb.joint_q[1], ts.joint_q)
    rng = np.random.RandomState(4)
    q = (np.tile(tm.joint_q0.numpy(), (3, 1))
         + 0.1 * rng.randn(3, 15)).astype(np.float32)
    t3 = nt.eval_fk(tm, torch.as_tensor(q), torch.zeros(3, 14),
                    nt.batch_state(tm.state(), 3))
    j3 = bridge.state_to_numpy(t3)
    for i in range(3):
        got = bridge.state_to_numpy(unbatch_env(t3, i))
        ref = j_unbatch_env(j3, i)
        for name in ("body_q", "joint_q", "joint_qd", "particle_q"):
            np.testing.assert_array_equal(got[name], np.asarray(ref[name]))


def test_vmap_step_maps_a_plain_step(ant):
    """vmap_step of a one-world step in plain PyTorch (FK from the
    coordinates) equals the step applied env by env."""
    tm, _, _, _ = ant
    rng = np.random.RandomState(5)
    q = (np.tile(tm.joint_q0.numpy(), (4, 1))
         + 0.2 * rng.randn(4, 15)).astype(np.float32)
    sb = nt.batch_state(tm.state(), 4).replace(
        joint_q=torch.as_tensor(q),
        joint_qd=torch.as_tensor(rng.randn(4, 14).astype(np.float32)))

    def fk(s):
        return nt.eval_fk(tm, s.joint_q, s.joint_qd, s)
    out = vmap_step(fk)(sb)
    assert out.body_q.shape == (4, 13, 7)
    for i in range(4):
        ref = fk(unbatch_env(sb, i))
        np.testing.assert_allclose(out.body_q[i].numpy(),
                                   ref.body_q.numpy(), atol=1e-6)
        np.testing.assert_allclose(out.body_qd[i].numpy(),
                                   ref.body_qd.numpy(), atol=1e-5)
