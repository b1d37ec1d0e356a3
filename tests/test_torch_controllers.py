"""The port's actuators, clamps, controllers and ONNX interpreter against
the JAX package's, on the same inputs (numpy, seeded): the delay ring
(with the reference's one-step-short lag, ROADMAP C.35), the Actuator,
the three clamps (ClampPositionBased's coordinate-for-dof read on the ant,
C.36), PD, PID and both joint-impedance controllers on two ants;
``encode_mlp``'s bytes; every operation of the ONNX interpreter, LSTM
included, through both packages' ``OnnxModule`` on the same bytes; an
unknown operation raising; the MLP and LSTM controllers. Tolerances:
float32 elementwise, 1e-5 absolute and relative (the model-based
impedance torques, of order 100 N m from a CRBA and an RNEA summed in
other orders, 1e-3 absolute and 1e-4 relative)."""

import struct

import numpy as np
import pytest
import torch

import newton_tpu_torch as nt
from newton_tpu_torch.actuators import (Actuator, ClampDCMotor,
                                        ClampMaxEffort, ClampPositionBased,
                                        Delay)
from newton_tpu_torch.controllers import (ControllerNeuralLSTM,
                                          ControllerNeuralMLP, ControllerPD,
                                          ControllerPID,
                                          JointImpedanceModelBased,
                                          JointImpedanceModelFree,
                                          OnnxModule, encode_mlp,
                                          load_onnx_weights)
from newton_tpu_torch.controllers import onnx_runtime as tor

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _close(got, ref, **tol):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(ref),
                               **(tol or TOL))


# ----------------------------------------------------------------------
# delay ring and actuator
# ----------------------------------------------------------------------

@pytest.mark.parametrize("steps", [0, 1, 2, 3])
def test_delay_matches_jax_and_lags_one_short(steps):
    """Feeding 1..5: steps = 1 does not delay, steps = k lags k - 1 (the
    JAX package writes slot head % k and reads (head + 1) % k)."""
    import jax.numpy as jnp
    from newton_tpu.actuators import Delay as JDelay
    jd, td = JDelay(steps, 1), Delay(steps, 1, device="cpu")
    jc, tc = jd.init(), td.init()
    got, ref = [], []
    for u in range(1, 6):
        jc, jo = jd(jc, jnp.asarray([float(u)]))
        tc, to = td(tc, torch.tensor([float(u)]))
        ref.append(float(jo[0]))
        got.append(float(to[0]))
    assert got == ref
    lag = max(steps - 1, 0)
    assert got == [0.0] * lag + [1.0, 2, 3, 4, 5][:5 - lag]


@pytest.fixture(scope="module")
def ants():
    """Two gymnasium ants on both sides, at one random state: hinge
    coordinates spread over their ranges, random velocities."""
    import jax.numpy as jnp
    import newton_tpu as jt
    from newton_tpu.sim.articulation import eval_fk as j_fk
    out = {}
    for lib in (jt, nt):
        r = lib.ModelBuilder()
        r.add_mjcf(nt.ASSET_DIR + "/ant.xml")
        b = lib.ModelBuilder()
        b.replicate(r, 2)
        out[lib.__name__] = b.finalize() if lib is jt else b.finalize("cpu")
    jm, tm = out["newton_tpu"], out["newton_tpu_torch"]
    rng = np.random.default_rng(0)
    q = np.asarray(jm.joint_q0).copy()
    q.reshape(2, -1)[:, 7:] += rng.uniform(-0.5, 0.5, (2, 8))
    qd = rng.normal(0, 1, jm.joint_dof_count).astype(np.float32)
    js = j_fk(jm, jnp.asarray(q, jnp.float32), jnp.asarray(qd), jm.state())
    ts = nt.eval_fk(tm, torch.as_tensor(q, dtype=torch.float32),
                    torch.as_tensor(qd), tm.state())
    # the hinge dofs (6..13 of each world) and coordinates (7..14)
    dofs = (np.arange(2)[:, None] * 14 + np.arange(6, 14)).reshape(-1)
    coords = (np.arange(2)[:, None] * 15 + np.arange(7, 15)).reshape(-1)
    return jm, tm, js, ts, dofs, coords, rng


def test_actuator_matches_jax(ants):
    """PD towards random targets, clamped at 150, two steps of a two-step
    delay (the second step's effort is the first command's)."""
    import jax.numpy as jnp
    from newton_tpu.actuators import Actuator as JA
    from newton_tpu.actuators import ClampMaxEffort as JC
    from newton_tpu.controllers import ControllerPD as JPD
    jm, tm, js, ts, dofs, coords, rng = ants
    ja = JA(jm, dofs, JPD(40.0, 1.0, coord_indices=coords), JC(150.0), 2)
    ta = Actuator(tm, dofs, ControllerPD(40.0, 1.0, coord_indices=coords),
                  ClampMaxEffort(150.0), delay_steps=2)
    jcar, tcar = ja.init_carry(), ta.init_carry()
    jc, tc = jm.control(), tm.control()
    for _ in range(2):
        cmd = rng.uniform(-1, 1, len(dofs)).astype(np.float32)
        jcar, jout = ja(jcar, js, jc, jnp.asarray(cmd))
        tcar, tout = ta(tcar, ts, tc, torch.as_tensor(cmd))
        _close(tout.joint_f, jout.joint_f)
    assert float(tout.joint_f.abs().max()) <= 150.0
    assert float(tc.joint_f.abs().max()) == 0.0      # inputs untouched


def test_clamps_match_jax(ants):
    """The three clamps on random efforts; ClampPositionBased reads
    joint_q at the dof indices (C.36): behind the ant's free root that is
    one coordinate early for every hinge, the root quaternion's w for the
    first."""
    import jax.numpy as jnp
    from newton_tpu.actuators import clamping as jcl
    jm, tm, js, ts, dofs, coords, rng = ants
    effort = rng.normal(0, 200, len(dofs)).astype(np.float32)
    td = torch.as_tensor(dofs)
    for jc, tc in ((jcl.ClampMaxEffort(None), ClampMaxEffort(None)),
                   (jcl.ClampMaxEffort(120.0), ClampMaxEffort(120.0)),
                   (jcl.ClampPositionBased(0.3), ClampPositionBased(0.3)),
                   (jcl.ClampDCMotor(100.0, 3.0), ClampDCMotor(100.0, 3.0))):
        ref = jc(jm, js, jnp.asarray(effort), dofs)
        got = tc(tm, ts, torch.as_tensor(effort), td)
        _close(got, ref)
    # C.36: hinge k's position is read at coordinate dofs[k], one before
    # its own coordinate coords[k]; world 0's first hinge reads coordinate
    # 6, the root quaternion's w
    q = np.asarray(js.joint_q)
    assert dofs[0] == 6 and coords[0] == 7
    assert q[dofs[0]] == q[6] and abs(q[6] - 1.0) < 1e-6  # the root's w


def test_pd_pid_and_impedance_match_jax(ants):
    import jax.numpy as jnp
    from newton_tpu.controllers import ControllerPD as JPD
    from newton_tpu.controllers import ControllerPID as JPID
    from newton_tpu.controllers import JointImpedanceModelBased as JIB
    from newton_tpu.controllers import JointImpedanceModelFree as JIF
    jm, tm, js, ts, dofs, coords, rng = ants
    kp = rng.uniform(10, 50, len(dofs)).astype(np.float32)
    kd = rng.uniform(0.5, 2, len(dofs)).astype(np.float32)
    qt = rng.uniform(-0.5, 0.5, len(dofs)).astype(np.float32)
    stacked = np.stack([qt, rng.normal(0, 1, len(dofs))]).astype(np.float32)
    td = torch.as_tensor(dofs)
    for cmd in (qt, stacked):
        for J, T in ((JPD, ControllerPD), (JIF, JointImpedanceModelFree)):
            ref = J(kp, kd, coord_indices=coords)(jm, js, jnp.asarray(cmd),
                                                  dofs)
            got = T(kp, kd, coord_indices=coords)(tm, ts,
                                                  torch.as_tensor(cmd), td)
            _close(got, ref)
        ref = JIB(jm, kp, kd, coord_indices=coords)(jm, js,
                                                   jnp.asarray(cmd), dofs)
        got = JointImpedanceModelBased(tm, kp, kd, coord_indices=coords)(
            tm, ts, torch.as_tensor(cmd), td)
        _close(got, ref, atol=1e-3, rtol=1e-4)
    jp = JPID(kp, 2.0, kd, i_limit=0.05, coord_indices=coords)
    tp = ControllerPID(kp, 2.0, kd, i_limit=0.05, coord_indices=coords)
    ji, ti = jp.init(len(dofs)), tp.init(len(dofs))
    for _ in range(3):
        ji, jref = jp.step(ji, jm, js, jnp.asarray(qt), dofs, 0.01)
        ti, tgot = tp.step(ti, tm, ts, torch.as_tensor(qt), td, 0.01)
        _close(ti, ji)
        _close(tgot, jref)


# ----------------------------------------------------------------------
# ONNX: encoder bytes, every interpreter operation, the neural controllers
# ----------------------------------------------------------------------

def _mlp(rng, sizes):
    return [(rng.normal(0, 1, (a, b)).astype(np.float32) / np.sqrt(a),
             rng.normal(0, 0.1, b).astype(np.float32))
            for a, b in zip(sizes[:-1], sizes[1:])]


def test_encode_mlp_bytes_match_jax():
    from newton_tpu.controllers import encode_mlp as j_encode
    layers = _mlp(np.random.default_rng(1), [36, 64, 64, 8])
    for act, out in (("Tanh", "Tanh"), ("Relu", None), ("Elu", "Sigmoid")):
        assert encode_mlp(layers, act, out) == j_encode(layers, act, out)


_DT_CODE = {np.float32: 1, np.int64: 7}


def _tensor(name, arr):
    arr = np.asarray(arr)
    out = b"".join(tor._enc_field(1, 0, d) for d in arr.shape)
    out += tor._enc_field(2, 0, _DT_CODE[arr.dtype.type])
    out += tor._enc_field(8, 2, name.encode())
    return out + tor._enc_field(9, 2, arr.tobytes())


def _attr(name, value):
    """An AttributeProto: float, int, ints or tensor."""
    out = tor._enc_field(1, 2, name.encode())
    if isinstance(value, float):
        return out + tor._enc_varint((2 << 3) | 5) + struct.pack("<f", value)
    if isinstance(value, int):
        return out + tor._enc_field(3, 0, value)
    if isinstance(value, np.ndarray):
        return out + tor._enc_field(5, 2, _tensor("", value))
    return out + tor._enc_field(8, 2, b"".join(
        tor._enc_varint(v) for v in value))


def _model(nodes, inits, inputs, outputs):
    """ONNX bytes of a graph: nodes (op, ins, outs, attrs dict)."""
    g = b""
    for op, ins, outs, attrs in nodes:
        n = b"".join(tor._enc_field(1, 2, i.encode()) for i in ins)
        n += b"".join(tor._enc_field(2, 2, o.encode()) for o in outs)
        n += tor._enc_field(4, 2, op.encode())
        n += b"".join(tor._enc_field(5, 2, _attr(k, v))
                      for k, v in attrs.items())
        g += tor._enc_field(1, 2, n)
    g += b"".join(tor._enc_field(5, 2, _tensor(k, v))
                  for k, v in inits.items())
    g += b"".join(tor._enc_field(11, 2, tor._enc_value_info(i))
                  for i in inputs + list(inits))
    g += b"".join(tor._enc_field(12, 2, tor._enc_value_info(o))
                  for o in outputs)
    return tor._enc_field(1, 0, 8) + tor._enc_field(7, 2, g)


def _op_cases():
    """(name, ONNX bytes, inputs) for each operation of the interpreter."""
    rng = np.random.default_rng(2)
    X = rng.normal(0, 1, (4, 6)).astype(np.float32)
    C = rng.uniform(0.5, 2.0, (4, 6)).astype(np.float32)
    W = rng.normal(0, 1, (6, 5)).astype(np.float32)
    c = {}

    def unary(op, **attrs):
        return _model([(op, ["x"], ["y"], attrs)], {}, ["x"], ["y"]), [X]

    def binary(op):
        return _model([(op, ["x", "c"], ["y"], {})], {"c": C}, ["x"],
                      ["y"]), [X]

    c["Gemm"] = (_model([("Gemm", ["x", "w", "b"], ["y"],
                          dict(alpha=0.5, beta=2.0, transB=1))],
                        {"w": W.T.copy(), "b": rng.normal(0, 1, 5)
                         .astype(np.float32)}, ["x"], ["y"]), [X])
    c["MatMul"] = (_model([("MatMul", ["x", "w"], ["y"], {})], {"w": W},
                          ["x"], ["y"]), [X])
    for op in ("Add", "Sub", "Mul", "Div"):
        c[op] = binary(op)
    for op in ("Neg", "Relu", "Tanh", "Sigmoid", "Exp", "Identity", "Cast"):
        c[op] = unary(op)
    c["Elu"] = unary("Elu", alpha=0.7)
    c["LeakyRelu"] = unary("LeakyRelu", alpha=0.2)
    c["Softmax"] = unary("Softmax", axis=1)
    c["Clip"] = (_model([("Clip", ["x", "lo", "hi"], ["y"], {})],
                        {"lo": np.float32(-0.3) * np.ones((), np.float32),
                         "hi": np.float32(0.4) * np.ones((), np.float32)},
                        ["x"], ["y"]), [X])
    c["Clip-attrs"] = unary("Clip", min=-0.2, max=0.5)
    c["Concat"] = (_model([("Concat", ["x", "c"], ["y"], dict(axis=1))],
                          {"c": C}, ["x"], ["y"]), [X])
    c["Constant"] = (_model([("Constant", [], ["k"], dict(value=C)),
                             ("Add", ["x", "k"], ["y"], {})], {}, ["x"],
                            ["y"]), [X])
    c["Reshape"] = (_model([("Reshape", ["x", "s"], ["y"], {})],
                           {"s": np.array([2, 12], np.int64)}, ["x"], ["y"]),
                    [X])
    c["Flatten"] = (_model([("Flatten", ["x"], ["y"], dict(axis=1))], {},
                           ["x"], ["y"]), [X.reshape(2, 3, 4)])
    c["Squeeze"] = (_model([("Squeeze", ["x"], ["y"], dict(axes=[1]))], {},
                           ["x"], ["y"]), [X.reshape(4, 1, 6)])
    c["Unsqueeze"] = (_model([("Unsqueeze", ["x"], ["y"],
                               dict(axes=[0, 2]))], {}, ["x"], ["y"]), [X])
    T, B, I, H = 3, 2, 4, 5
    c["LSTM"] = (_model(
        [("LSTM", ["x", "W", "R", "B", "", "h0", "c0"], ["Y", "Yh", "Yc"],
          dict(hidden_size=H))],
        {"W": rng.normal(0, 0.5, (1, 4 * H, I)).astype(np.float32),
         "R": rng.normal(0, 0.5, (1, 4 * H, H)).astype(np.float32),
         "B": rng.normal(0, 0.1, (1, 8 * H)).astype(np.float32),
         "h0": rng.normal(0, 0.5, (1, B, H)).astype(np.float32),
         "c0": rng.normal(0, 0.5, (1, B, H)).astype(np.float32)},
        ["x"], ["Y", "Yh", "Yc"]),
        [rng.normal(0, 1, (T, B, I)).astype(np.float32)])
    return c


_CASES = _op_cases()


@pytest.mark.parametrize("op", sorted(_CASES))
def test_onnx_op_matches_jax(op):
    from newton_tpu.controllers import OnnxModule as JOnnx
    data, inputs = _CASES[op]
    ref = JOnnx(data)(*inputs)
    got = OnnxModule(data, device="cpu")(*[torch.as_tensor(x)
                                           for x in inputs])
    refs = ref if isinstance(ref, tuple) else (ref,)
    gots = got if isinstance(got, tuple) else (got,)
    assert len(refs) == len(gots)
    for g, r in zip(gots, refs):
        assert tuple(g.shape) == tuple(np.asarray(r).shape)
        _close(g, r)


def test_onnx_unknown_op_raises():
    data = _model([("Foo", ["x"], ["y"], {})], {}, ["x"], ["y"])
    with pytest.raises(NotImplementedError, match="Foo"):
        OnnxModule(data, device="cpu")(torch.zeros(2, 3))


def test_onnx_mlp_policy_and_neural_controllers_match_jax():
    """The policy of the slice's main path (36 -> 64 -> 64 -> 8, Tanh)
    through encode_mlp and both OnnxModules; ControllerNeuralMLP and
    ControllerNeuralLSTM against the JAX ones; load_onnx_weights raises
    RuntimeError without the onnx package, as in JAX."""
    import jax.numpy as jnp
    from newton_tpu.controllers import ControllerNeuralLSTM as JL
    from newton_tpu.controllers import ControllerNeuralMLP as JM
    from newton_tpu.controllers import OnnxModule as JOnnx
    rng = np.random.default_rng(3)
    layers = _mlp(rng, [36, 64, 64, 8])
    data = encode_mlp(layers, "Tanh", "Tanh")
    obs = rng.normal(0, 1, (16, 36)).astype(np.float32)
    _close(OnnxModule(data, device="cpu")(torch.as_tensor(obs)),
           JOnnx(data)(obs))
    for act in ("elu", "gelu", "relu"):
        ref = JM(layers, act, "tanh")(None, None, jnp.asarray(obs), None)
        got = ControllerNeuralMLP(layers, act, "tanh", device="cpu")(
            None, None, torch.as_tensor(obs), None)
        _close(got, ref)
    H = 7
    p = [rng.normal(0, 0.3, s).astype(np.float32)
         for s in ((36, 4 * H), (H, 4 * H), (4 * H,), (4 * H,), (H, 8),
                   (8,))]
    jl, tl = JL(*p), ControllerNeuralLSTM(*p, device="cpu")
    jc, tc = jl.init((16,)), tl.init((16,))
    for _ in range(3):
        jc, ja = jl.step(jc, jnp.asarray(obs))
        tc, ta = tl.step(tc, torch.as_tensor(obs))
        _close(ta, ja)
    try:
        import onnx  # noqa: F401
    except ImportError:
        with pytest.raises(RuntimeError, match="ONNX reader"):
            load_onnx_weights("policy.onnx")
