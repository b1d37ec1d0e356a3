"""Articulation dynamics API: mass matrices, Jacobians and inverse
dynamics (port of ``newton_tpu/sim/dynamics_api.py``).

Each function returns one batch per articulation group of the
generalized solver (articulations of one topology; the rows of a group
are its articulations, so a replicated model's group axis is the world
axis), computed from the group's row tables: the dof subspace, the CRBA
and the RNEA of ``solvers/generalized/batched.py``. The tables come from
a ``SolverFeatherstone`` of the model, built at the first call and kept
on the Model (a Model made by ``dataclasses.replace`` builds its own;
after an edit of a Model's tensors in place, call
``dynamics_solver(model).notify_model_changed()``). A group without dofs
is left out; a group mounted on another articulation's body raises in
``eval_inverse_dynamics`` (its bias needs the whole model's RNEA).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..math import cross
from .model import Model
from .state import State

__all__ = ["eval_mass_matrix", "eval_jacobian", "eval_inverse_dynamics",
           "eval_dense_jacobian_rows", "dynamics_solver"]


def dynamics_solver(model: Model):
    """The ``SolverFeatherstone`` whose group tables these functions read,
    built once per Model."""
    solver = model.__dict__.get("_dynamics_solver")
    if solver is None:
        from ..solvers.generalized.solver import SolverFeatherstone
        solver = SolverFeatherstone(model)
        model.__dict__["_dynamics_solver"] = solver
    return solver


def _groups(model: Model, state: State):
    """(group, rows, v_o, w_o, x_b, Iw) of every group with dofs at the
    flat ``state``: the group's rows gathered, the row-local dof subspace
    at the origin, world COMs and world inertias."""
    from ..solvers.generalized.batched import (_dof_subspace, _gather_rows,
                                               _spatial_inertia)
    for grp in dynamics_solver(model).groups:
        t = grp.tables
        if t.d == 0:
            continue
        rows, _, _ = _gather_rows(grp, state, None, None)
        v_o, w_o = _dof_subspace(t, rows.body_q, rows.joint_q)
        x_b, Iw = _spatial_inertia(grp.row_model, rows.body_q)
        yield grp, rows, v_o, w_o, x_b, Iw


def eval_mass_matrix(model: Model, state: State) -> List[torch.Tensor]:
    """Joint-space mass matrices, one ``(n, d, d)`` tensor per articulation
    group (CRBA, with the joints' armature on the diagonal)."""
    from ..solvers.generalized.batched import _crba
    return [_crba(grp.tables, v_o, w_o, x_b, Iw,
                  grp.row_model.body_mass)
            for grp, _, v_o, w_o, x_b, Iw in _groups(model, state)]


def eval_jacobian(model: Model, state: State) -> List[torch.Tensor]:
    """Body Jacobians ``(n, b, 6, d)`` per articulation group: the twist
    ``[v_com, w]`` of each of the group's bodies (ascending body index)
    per unit velocity of each of its dofs."""
    out = []
    for grp, _, v_o, w_o, x_b, _ in _groups(model, state):
        t = grp.tables
        vg, wg = v_o[:, t.di], w_o[:, t.di]                   # (n, d, 3)
        xg = x_b[:, t.bi]                                     # (n, b, 3)
        anc = t.anc[None, :, :, None]                         # (1, b, d, 1)
        V = (vg[:, None] + cross(wg[:, None], xg[:, :, None])) * anc
        W = wg[:, None].expand_as(V) * anc
        out.append(torch.cat([V, W], -1).transpose(2, 3))
    return out


def eval_dense_jacobian_rows(model: Model, state: State,
                             points: torch.Tensor, bodies, dirs: torch.Tensor,
                             group_index: int = 0) -> torch.Tensor:
    """Task-space Jacobian rows ``dir . v(point)`` (n, p, d) of group
    ``group_index``: world points ``points`` (n, p, 3) fixed to the
    group's bodies ``bodies`` (p,) (positions in the group's ascending
    body order) along world directions ``dirs`` (n, p, 3)."""
    groups = list(_groups(model, state))
    grp, _, v_o, w_o, _, _ = groups[group_index]
    t = grp.tables
    vg, wg = v_o[:, t.di], w_o[:, t.di]
    b = torch.as_tensor(bodies, dtype=torch.long, device=t.anc.device)
    Vp = vg[:, None] + cross(wg[:, None], points[:, :, None, :])
    Vp = Vp * t.anc[b][None, :, :, None]
    return torch.einsum("npx,npdx->npd", dirs, Vp)


def eval_inverse_dynamics(model: Model, state: State,
                          qdd: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Generalized forces (D,) realizing ``qdd`` (D,) at the flat
    ``state``: tau = M qdd + bias(q, qd) (RNEA: gravity, Coriolis and
    centrifugal terms); with ``qdd=None`` the bias alone. A group's dofs
    do not repeat, so each group's rows are written with a plain indexed
    assignment."""
    from ..solvers.generalized.batched import _bias_forces, _crba
    tau = state.joint_qd.new_zeros(state.joint_qd.shape)
    for grp, rows, v_o, w_o, x_b, Iw in _groups(model, state):
        if grp.mounts is not None:
            raise NotImplementedError(
                "eval_inverse_dynamics of an articulation mounted on "
                "another's body is not ported")
        t = grp.tables
        tg = _bias_forces(t, grp.row_model, rows.body_qd, v_o, w_o, x_b,
                          Iw)[:, t.di]
        if qdd is not None:
            M = _crba(t, v_o, w_o, x_b, Iw, grp.row_model.body_mass)
            qg = qdd[t.row_dof][:, t.di]
            tg = tg + torch.einsum("nde,ne->nd", M, qg)
        tau[t.row_dof[:, t.di]] = tg
    return tau
