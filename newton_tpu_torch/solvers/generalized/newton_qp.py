"""Active-set Newton solve of the contact QP on pyramid facets (port of
``_solve_contacts_newton`` in ``newton_tpu/solvers/generalized/
solver.py``, the reference's ``SolverMuJoCo(solver="newton")``).

Per contact, four facet directions ``n + mu t1``, ``n - mu t1``, ``n + mu
t2``, ``n - mu t2`` carry impulses x >= 0; the normal impulse is their sum
and the tangential ones ``mu (x0 - x1)`` and ``mu (x2 - x3)``. The limit
rows (signed one-hots on the limited dofs) follow the facets. The QP

    min 0.5 x^T (Jf M^-1 Jf^T + R) x + x^T (Jf qd - b),  x >= 0

is solved by ``newton_iterations`` projected Newton steps, each a masked
SPD system (the free rows and columns of A, the identity elsewhere) solved
by ``torch.linalg.solve_ex`` without its error check, so the loop never
waits for the device: the counterpart of the JAX package's
``jnp.linalg.solve``, a library call, not the port of a kernel. A
non-finite iterate resets to 0, as in the JAX package.

The operands are B2's (``batched._contact_system``): J (W, 3c, d) in
block order [n | t1 | t2], its b rows (where a two-sided contact's moving
support shifted them) and act rows, mu (W, c) and ``w_other``. Minv may be
non-symmetric: the system uses ``Minv Jf^T`` as the reference does.
"""

from __future__ import annotations

import torch

__all__ = ["solve_contacts_newton"]


def solve_contacts_newton(J, Minv, qd, b, act, mu, *, c, E, impratio, reg,
                          iterations, w_other=None, record=None):
    """``E`` (nl, d) the limit rows' one-hots on their dofs. Returns (lam
    (W, 3c + 2 nl): the per-contact impulses [n | t1 | t2] reported from
    the facets, then the limit rows; dqd (W, d))."""
    W, _, d = J.shape
    nl = E.shape[0]
    Jn, Jt1, Jt2 = J[:, 0:c], J[:, c:2 * c], J[:, 2 * c:3 * c]
    m = mu[..., None]
    rows = [Jn + m * Jt1, Jn - m * Jt1, Jn + m * Jt2, Jn - m * Jt2]
    bn, bt1, bt2 = b[:, 0:c], b[:, c:2 * c], b[:, 2 * c:3 * c]
    # b of a facet: the moving support's shift of its three rows
    b_f = [bn + mu * bt1, bn - mu * bt1, bn + mu * bt2, bn - mu * bt2]
    act_n = act[:, 0:c]
    act_f = [act_n] * 4
    if nl:
        E = E.expand(W, nl, d)
        rows += [E, -E]
        b_f.append(b[:, 3 * c:])
        act_f.append(act[:, 3 * c:])
    Jf = torch.cat(rows, dim=1)                              # (W, r, d)
    cvec = (Jf @ qd[:, :, None])[..., 0] - torch.cat(b_f, dim=1)
    act_f = torch.cat(act_f, dim=1)
    r = Jf.shape[1]
    MinvJf = Minv @ Jf.transpose(1, 2)                       # (W, d, r)
    A = Jf @ MinvJf                                          # (W, r, r)
    diag_A = torch.diagonal(A, dim1=1, dim2=2)
    R = diag_A * ((1.0 - impratio) / impratio) + reg
    A = A + torch.diag_embed(R)
    if w_other is not None:
        # the other body's point inverse mass on the facet diagonal (w_n +
        # mu^2 w_t; cross terms drop in the diagonal approximation)
        wn, wt1, wt2 = (w_other[:, 0:c], w_other[:, c:2 * c],
                        w_other[:, 2 * c:3 * c])
        w1, w2 = wn + mu ** 2 * wt1, wn + mu ** 2 * wt2
        wf = [w1, w1, w2, w2]
        if nl:
            wf.append(w_other.new_zeros(W, 2 * nl))
        A = A + torch.diag_embed(torch.cat(wf, dim=1))
    actf = act_f.to(J.dtype)
    x = torch.zeros((W, r), dtype=J.dtype, device=J.device)
    eye = torch.eye(r, dtype=J.dtype, device=J.device)
    for _ in range(iterations):
        grad = (A @ x[:, :, None])[..., 0] + cvec
        free = ((act_f > 0) & ((x > 0) | (grad < 0))).to(J.dtype)
        # the masked SPD system: free rows and columns of A, the identity
        # elsewhere
        H = A * (free[:, :, None] * free[:, None, :]) + eye * (
            1.0 - free)[:, None, :]
        rhs = -(grad * free)
        if record is not None:
            record["newton_H"] = (H, rhs)
        dx = torch.linalg.solve_ex(H, rhs[..., None],
                                   check_errors=False)[0][..., 0]
        x = torch.clamp(x + dx * free, min=0.0) * actf
        x = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
    dqd = (MinvJf @ x[:, :, None])[..., 0]
    xf = x[:, :4 * c].view(W, 4, c)
    lam = [xf.sum(1), mu * (xf[:, 0] - xf[:, 1]), mu * (xf[:, 2] - xf[:, 3])]
    if nl:
        lam.append(x[:, 4 * c:])
    return torch.cat(lam, dim=1), dqd
