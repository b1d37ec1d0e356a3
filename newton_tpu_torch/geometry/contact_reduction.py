"""Contact reduction (port of ``newton_tpu/geometry/contact_reduction.py``):
spatially and directionally diverse representatives of an oversampled
contact set, per pair, with fixed shapes.

Each of the k picks maximizes depth plus a diversity bonus, the smallest
distance to the picks so far (position over the candidate cloud's extent,
plus the normals' disagreement): the deepest candidate is always the
first pick, clustered duplicates are suppressed, and the patch's corners
come next. Every pick is ``argmax`` (its first maximum, as ``jnp.argmax``),
so ties resolve to the lower candidate index on the CPU and on the card.
The hydroelastic variant then clusters every active candidate to its
nearest representative and sums the clusters' forces, so the reduced set
keeps the patch's total force exactly.
"""

from __future__ import annotations

import torch

__all__ = ["reduce_contact_set", "reduce_contact_set_hydro"]

_NEG = -1.0e30
# inactive candidates: below every depth plus bonus, yet small enough that
# an O(1) bonus still changes a float32 score (-1e30 + 1 == -1e30)
_INACTIVE = -1.0e6


def _take(a, idx):
    """a (..., K, c) at idx (..., k) along the candidate axis."""
    return torch.gather(a, -2, idx[..., None].expand(*idx.shape,
                                                     a.shape[-1]))


def _norm(x):
    return torch.sqrt((x * x).sum(-1))


def _greedy(pos, nrm, depth, k, spacing, normal_weight, active, keep_divs):
    """The k greedy picks (..., k) and, with ``keep_divs``, each pick's
    distance to every candidate (..., K, k)."""
    K = depth.shape[-1]
    extent = torch.clamp((pos.amax(-2) - pos.amin(-2)).amax(-1), min=1e-6)
    inv_ext = (spacing / extent)[..., None]
    pos, nrm = pos.detach(), nrm.detach()
    base = depth if active is None else torch.where(active, depth,
                                                    _INACTIVE)
    taken = torch.zeros(depth.shape, dtype=torch.bool, device=depth.device)
    min_div = torch.full_like(depth, torch.inf)
    picks, divs = [], []
    ar = torch.arange(K, device=depth.device)
    for s in range(k):
        bonus = torch.where(torch.isinf(min_div), 0.0, min_div)
        score = base + bonus
        if s > 0:
            # an exact duplicate of a pick (padded repeated samples) adds
            # no information but would add a duplicate row: demote it
            score = torch.where(min_div < 1e-9, _INACTIVE + score, score)
        score = torch.where(taken, _NEG, score)
        idx = torch.argmax(score, -1)
        picks.append(idx)
        taken = taken | (ar == idx[..., None])
        if s == k - 1 and not keep_divs:
            break
        p_sel = _take(pos, idx[..., None])
        n_sel = _take(nrm, idx[..., None])
        d_pos = _norm(pos - p_sel) * inv_ext
        d_nrm = (1.0 - (nrm * n_sel).sum(-1)) * normal_weight * spacing
        div = d_pos + d_nrm
        divs.append(div)
        min_div = torch.minimum(min_div, div)
    return torch.stack(picks, -1), divs


def reduce_contact_set(pos, nrm, depth, k, *, spacing: float = 1.0,
                       normal_weight: float = 0.5, active=None):
    """Greedy diverse selection of k of the K candidates: pos, nrm
    (..., K, 3), depth (..., K) (> 0 penetrating), active (..., K) bool or
    None (an inactive candidate is picked only where a row has fewer than
    k active ones, with its own depth, which the caller's margin test then
    rejects). Returns (pos_k, nrm_k, depth_k), (..., k, ...)."""
    k = int(min(k, depth.shape[-1]))
    idx, _ = _greedy(pos, nrm, depth, k, spacing, normal_weight, active,
                     False)
    return _take(pos, idx), _take(nrm, idx), torch.gather(depth, -1, idx)


def reduce_contact_set_hydro(pos, nrm, depth, fmag, k, *,
                             spacing: float = 1.0,
                             normal_weight: float = 0.5, active=None):
    """Wrench-conserving reduction: the same k picks, every active
    candidate then assigned to its nearest pick (its first nearest), and
    per cluster f_k = the sum of its members' ``fmag`` (area times
    pressure), pos_k the fmag-weighted centroid (the cluster's centre of
    pressure), nrm_k the fmag-weighted mean normal, normalized; a cluster
    without force keeps its representative's point and normal. Returns
    (pos_k, nrm_k, depth_k (the representatives' own depths), f_k)."""
    k = int(min(k, depth.shape[-1]))
    idx, divs = _greedy(pos, nrm, depth, k, spacing, normal_weight, active,
                        True)
    dist = torch.stack(divs, -1)                                # (..., K, k)
    assign = (torch.argmin(dist, -1)[..., None] == torch.arange(
        k, device=dist.device)).to(pos.dtype)
    w = fmag if active is None else torch.where(active, fmag, 0.0)
    wk = assign * w[..., None]                                  # (..., K, k)
    f_k = wk.sum(-2)
    has_f = (f_k > 1e-12)[..., None]
    safe = torch.where(has_f[..., 0], f_k, 1.0)[..., None]
    pos_k = torch.einsum("...Kk,...Kc->...kc", wk, pos) / safe
    nrm_k = torch.einsum("...Kk,...Kc->...kc", wk, nrm)
    nrm_k = nrm_k * torch.rsqrt(torch.clamp(
        (nrm_k * nrm_k).sum(-1, keepdim=True), min=1e-12))
    pos_k = torch.where(has_f, pos_k, _take(pos, idx))
    nrm_k = torch.where(has_f, nrm_k, _take(nrm, idx))
    return pos_k, nrm_k, torch.gather(depth, -1, idx), f_k
