"""The port's ``basic_shapes`` example (every primitive shape dropped onto
the ground) against the JAX package's on the CPU, frame by frame from the
same start, 4 frames of 4 substeps.

The JAX side runs its collide eagerly and its XPBD substep jitted: the
example's jitted frame compiles for minutes (the support-map MPR and GJK
loops of its cone and ellipsoid pairs), an eager frame takes ~16 s. The
pairs between bodies stay far apart in these frames, so their MPR rows
are inactive; the shapes fall freely toward the ground. Tolerances as
``test_torch_examples_basic_parity.py``: ``body_q``/``joint_q`` 2e-4,
``body_qd``/``joint_qd`` 5e-3, atol = rtol.
"""

import torch

from test_torch_examples_basic_parity import examples, frame_by_frame

torch.set_num_threads(1)


def test_basic_shapes_matches_jax_frame_by_frame():
    import jax
    jex, tex = examples("basic_shapes")
    sub = jax.jit(lambda s, c: jex.solver.step(s, None, None, c,
                                               jex.sim_dt))

    def jax_frame(ex):
        for _ in range(ex.substeps):
            ex.state = sub(ex.state, ex.pipeline.collide(ex.state))
        ex.time += ex.sim_dt * ex.substeps
    frame_by_frame("basic_shapes", 4, jax_step=jax_frame,
                   pair=(jex, tex))
