"""Sums of terms into destinations in a fixed order.

``index_add_`` runs as float atomics on CUDA: terms that share a
destination add in whatever order the threads arrive, so two runs of one
step may differ in the last bits. Where the destination of every term is
static (a constraint list, a joint list, the static pipeline's contact
slots), ``FixedOrderSum`` sorts the terms by destination once, at plan
time, with a stable sort, and pads each destination's list to the largest
degree with a sentinel that reads an appended zero row. Each sum is then
one gather and one ``sum`` over the padded axis: a PyTorch reduction with
no atomics, adding in the same order every run.

Where the destinations are a device tensor that changes every call (the
dynamic-pair pipeline reassigns its contact slots every frame),
``DynamicOrderSum`` sorts them on the device with a stable sort, finds
each destination's run by binary search and reduces each run in sorted
(= term) order with ``torch.segment_reduce``: no float atomics, no host
sync (no degree is read back), the same bits every run.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["FixedOrderSum", "DynamicOrderSum", "soft_contact_sum",
           "slot_body_dst", "check_static_slots"]


class FixedOrderSum:
    """``out[d] = sum of terms[i] with dst[i] == d``, in a fixed order.

    ``dst`` (n_terms,) host integers; a negative destination drops its
    term. ``table`` is (n_dest, max_degree): each destination's terms in
    ascending term order, padded with ``n_terms`` (the zero row appended
    at call time)."""

    def __init__(self, dst, n_dest: int, device):
        dst = np.asarray(dst, dtype=np.int64).reshape(-1)
        self.n_terms, self.n_dest = len(dst), int(n_dest)
        keep = np.nonzero(dst >= 0)[0]
        order = keep[np.argsort(dst[keep], kind="stable")]
        d = dst[order]
        counts = np.bincount(d, minlength=self.n_dest)
        k = int(counts.max(initial=0))
        starts = np.cumsum(counts) - counts
        table = np.full((self.n_dest, k), self.n_terms, dtype=np.int64)
        table[d, np.arange(len(d)) - starts[d]] = order
        self.max_degree = k
        self.table = torch.as_tensor(table, device=device)

    def __call__(self, terms: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Sum ``terms`` (its axis ``dim`` of length n_terms) into
        (n_dest,) along that axis."""
        dim = dim % terms.dim()
        if terms.shape[dim] != self.n_terms:
            raise ValueError(f"expected {self.n_terms} terms along axis "
                             f"{dim}, got {terms.shape[dim]}")
        shape = list(terms.shape)
        shape[dim] = 1
        ext = torch.cat([terms, terms.new_zeros(shape)], dim)
        if self.max_degree == 1:
            return ext.index_select(dim, self.table[:, 0])
        g = ext.index_select(dim, self.table.reshape(-1))
        g = g.unflatten(dim, (self.n_dest, self.max_degree))
        return g.sum(dim + 1)


class DynamicOrderSum:
    """``out[d] = sum of terms[i] with dst[i] == d``, each destination's
    terms added in ascending term order, for destinations ``dst``
    (n_terms,) on the device (negative: dropped). The order is planned
    once per ``dst`` (one stable sort, one binary search) and serves every
    call with those destinations."""

    def __init__(self, dst: torch.Tensor, n_dest: int):
        self.n_terms, self.n_dest = dst.shape[0], int(n_dest)
        key = torch.where(dst < 0, self.n_dest, dst.long())
        sk, self.perm = torch.sort(key, stable=True)
        self.offsets = torch.searchsorted(
            sk, torch.arange(self.n_dest + 1, device=dst.device))

    def __call__(self, terms: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Sum ``terms`` (its axis ``dim`` of length n_terms) into
        (n_dest,) along that axis."""
        dim = dim % terms.dim()
        if terms.shape[dim] != self.n_terms:
            raise ValueError(f"expected {self.n_terms} terms along axis "
                             f"{dim}, got {terms.shape[dim]}")
        g = terms.index_select(dim, self.perm).movedim(dim, 0)
        return torch.segment_reduce(g, "sum", offsets=self.offsets, axis=0,
                                    unsafe=True).movedim(0, dim)


def soft_contact_sum(structure, n_particles: int, device) -> FixedOrderSum:
    """The sum of per-slot soft-contact terms into the particles: the
    static pipeline's soft slots are ``structure.soft_pairs`` in order
    (``CollisionPipeline(model)``), each slot's particle first."""
    sp = np.asarray(structure.soft_pairs, dtype=np.int64).reshape(-1, 2)
    return FixedOrderSum(sp[:, 0], n_particles, device)


def slot_body_dst(structure, C: int, solver: str) -> np.ndarray:
    """The destinations of per-slot rows over the static pipeline's C
    rigid slots (``CollisionPipeline(model)`` fills ``slot_shape0/1`` in
    that order): each slot's body1, then each slot's body0, -1 where that
    side is static (its row is zero and dropped). Raises unless C is the
    pipeline's slot count."""
    S = len(np.asarray(structure.slot_shape0))
    if C and C != S:
        raise ValueError(
            f"{solver} sums the {S} contact slots of the model's static "
            f"pipeline (CollisionPipeline(model)); got {C}")
    if not C:
        return np.zeros(0, np.int64)
    sb = np.asarray(structure.shape_body, dtype=np.int64)

    def body(shape):
        shape = np.asarray(shape, dtype=np.int64)
        return np.where(shape >= 0, sb[np.maximum(shape, 0)], -1)
    return np.concatenate([body(structure.slot_shape1),
                           body(structure.slot_shape0)])


def check_static_slots(contacts, structure, rigid: bool = False,
                       soft: bool = False):
    """Raise unless ``contacts`` holds the static pipeline's slots, the
    destinations that the fixed-order contact sums are built from: rigid
    slot k between shapes ``slot_shape0/1[k]`` (or -1 there: an unused
    slot, whose terms are zero), soft slot k on particle
    ``soft_pairs[k, 0]``. Contacts that ``CollisionPipeline`` made for
    this structure carry it in ``contacts.slots`` and pass unread; any
    other Contacts is compared on the host, one sync per call."""
    if contacts.slots is structure:
        return
    checks = []
    if rigid:
        checks += [(contacts.rigid_contact_shape0, structure.slot_shape0,
                    "rigid_contact_shape0", True),
                   (contacts.rigid_contact_shape1, structure.slot_shape1,
                    "rigid_contact_shape1", True)]
    if soft:
        sp = np.asarray(structure.soft_pairs, dtype=np.int64).reshape(-1, 2)
        checks.append((contacts.soft_contact_particle, sp[:, 0],
                       "soft_contact_particle", False))
    for got, want, name, unused_ok in checks:
        g = got.cpu().numpy().reshape(-1).astype(np.int64)
        w = np.asarray(want, dtype=np.int64).reshape(-1)
        ok = g.shape == w.shape and bool(
            ((g == w) | ((g < 0) & unused_ok)).all())
        if not ok:
            raise ValueError(
                f"contacts.{name} does not hold the slots of the model's "
                "static pipeline (CollisionPipeline(model)), which the "
                "solver's fixed-order sums add into")
