"""A reference defect pinned (ROADMAP C.51): the JAX package's gradient
through ``SolverImplicitMPM.step`` is NaN. ``jax.grad`` of the summed
particle heights after 3 steps of 256 sand particles at res 16, from
rest, with respect to the start positions, is NaN in every entry; the
port's plain PyTorch step under autograd on the CPU gives NaN in the
same entries. So no backward of B3/B4 is ported, and on the card the
transfer kernels keep raising when grad is on and an input requires it
(``_kernels.refuse_grad``; its GPU case is in tests/test_torch_kernels.py).
If the reference gains a finite gradient, this test fails and the
backward can be ported against it.
"""

import numpy as np
import torch

import newton_tpu_torch as nt

torch.set_num_threads(1)

STEPS, DT = 3, 4e-4


def _sand(lib):
    b = lib.ModelBuilder()
    b.add_particle_grid(pos=(-0.1, -0.1, 0.3), dim_x=8, dim_y=8, dim_z=4,
                        cell_x=0.03, cell_y=0.03, cell_z=0.03, mass=0.02,
                        radius=0.012)
    return b


def test_mpm_gradient_is_nan_in_both_packages():
    import jax
    import jax.numpy as jnp
    import newton_tpu as jt
    from newton_tpu.solvers.solver_mpm import SolverImplicitMPM
    jm = _sand(jt).finalize()
    js = SolverImplicitMPM(jm, grid_lower=(-1, -1, 0), grid_upper=(1, 1, 2),
                           resolution=16)
    j0 = js.init_state(jm.state())

    def loss(q):
        s = j0.replace(particle_q=q)
        for _ in range(STEPS):
            s = js.step(s, None, None, None, DT)
        return jnp.sum(s.particle_q[:, 2])
    value, g_jax = jax.jit(jax.value_and_grad(loss))(j0.particle_q)
    assert np.isfinite(float(value))
    g_jax = np.asarray(g_jax)
    assert g_jax.shape == (256, 3)
    assert np.isnan(g_jax).all()

    tm = _sand(nt).finalize("cpu")
    ts = nt.SolverImplicitMPM(tm, grid_lower=(-1, -1, 0),
                              grid_upper=(1, 1, 2), resolution=16)
    s = ts.init_state(tm.state())
    q = s.particle_q.clone().requires_grad_(True)
    s = s.replace(particle_q=q)
    for _ in range(STEPS):
        s = ts.step(s, None, None, None, DT)
    s.particle_q[:, 2].sum().backward()
    np.testing.assert_array_equal(np.isnan(q.grad.numpy()),
                                  np.isnan(g_jax))
