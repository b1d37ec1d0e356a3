#!/usr/bin/env python3
"""Where do the card and the CPU part ways on a rigid XPBD scene of
chip_smoke.py?

    python3 tools/device_op_diff.py cone      # on a machine with a GPU
    python3 tools/device_op_diff.py cone shapes pile

For each scene: its first ``--worlds`` worlds (default 64) run on the card
to the state that its phase gates (phase 45's frames for ``cone`` and
``shapes``, phase 46's for ``pile``), then

1. four substeps on the card and on the CPU from that state, every world
   compared (no world left out): per substep, the worlds whose contact
   masks differ, the largest move of an active contact point, and the
   largest body_q/body_qd difference;
2. the CPU's own spread: the same four substeps on the CPU from the state
   with each body_q entry moved by one ulp (eight seeded draws of the
   directions), the largest body_q/body_qd difference to the unmoved run;
3. one collide and step on the card under a dispatch mode that repeats
   every operation on CPU copies of its inputs and compares the outputs
   bit for bit: each operation whose outputs differ on equal inputs, with
   its count, its largest difference and the port's source line that
   called it.

Prints one JSON object a scene; writes them to
chiprun_out/device_op_diff.json too.
"""

import json
import os
import sys
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def scene(cs, nt, name, n):
    """(builder, pipeline kwargs, frames, dt) of a chip_smoke.py scene."""
    if name == "cone":
        return cs.cone_stack_scene(nt, n), {}, cs.CONE_FRAMES, cs.DT
    if name == "shapes":
        return cs.basic_shapes_scene(nt, n)[0], {}, cs.SHAPES_FRAMES, cs.DT
    if name == "pile":
        return (cs.box_pile_scene(nt, n),
                dict(mode="dynamic", dynamic_pair_budget=8 * 96 * n),
                cs.PILE_FRAMES_46, 1.0 / 120.0)
    raise SystemExit(f"unknown scene {name}")


def op_diffs(fn):
    """Run ``fn`` with every CUDA operation repeated on CPU copies of its
    inputs; {op @ source line: [count, largest difference]} of the
    operations whose outputs differ."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten, tree_map

    def cpu(x):
        return x.detach().cpu() if isinstance(x, torch.Tensor) else x

    def where():
        for f in reversed(traceback.extract_stack()):
            if "newton_tpu_torch" in f.filename:
                return f"{os.path.relpath(f.filename, ROOT)}:{f.lineno}"
        return "?"

    found = {}

    class Mirror(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            flat = tree_flatten((args, kwargs))[0]
            on_card = any(isinstance(x, torch.Tensor) and x.is_cuda
                          for x in flat)
            mirror = on_card and "device" not in kwargs
            if mirror:
                c_args, c_kwargs = tree_map(cpu, (args, kwargs))
            out = func(*args, **kwargs)
            if not mirror:
                return out
            try:
                c_out = func(*c_args, **c_kwargs)
            except Exception:               # an op with no CPU twin here
                return out
            worst = 0.0
            for a, b in zip(tree_flatten(out)[0], tree_flatten(c_out)[0]):
                if not isinstance(a, torch.Tensor):
                    if a != b:
                        worst = max(worst, float("inf"))
                    continue
                a = a.detach().cpu()
                if a.shape != b.shape:
                    worst = float("inf")
                    continue
                if a.is_floating_point():
                    same = (a == b) | (a.isnan() & b.isnan())
                    if not bool(same.all()):
                        worst = max(worst, float((a - b)[~same].abs()
                                                 .nan_to_num(1e30).max()))
                elif not torch.equal(a, b):
                    worst = float("inf")
            if worst > 0.0:
                k = f"{func.__name__} @ {where()}"
                n, w = found.get(k, (0, 0.0))
                found[k] = (n + 1, max(w, worst))
            return out

    with Mirror():
        fn()
    return {k: list(v) for k, v in sorted(found.items())}


def study(cs, nt, name, n, substeps=4):
    import torch
    b, pipe_kw, frames, dt = scene(cs, nt, name, n)
    sides = {}
    for dev in ("cuda", "cpu"):
        m = b.finalize(dev)
        sides[dev] = (m, nt.CollisionPipeline(m, **pipe_kw),
                      nt.SolverXPBD(m, iterations=4))
    m, pipe, solver = sides["cuda"]
    s = m.state()
    for _ in range(frames * cs.SUBSTEPS):
        s = solver.step(s, None, None, pipe.collide(s), dt)
    gated = s.clone()
    out = dict(scene=name, worlds=n, frames=frames)

    def run(dev, s):
        _, p, sol = sides[dev]
        cs_, ss = [], []
        for _ in range(substeps):
            c = p.collide(s)
            s = sol.step(s, None, None, c, dt)
            cs_.append(c)
            ss.append(s)
        return cs_, ss

    k_d, s_d = run("cuda", gated)
    k_c, s_c = run("cpu", gated.to("cpu"))
    rows = []
    for i in range(substeps):
        a, c = k_d[i], k_c[i]
        ma, mc = a.rigid_contact_mask.cpu(), c.rigid_contact_mask
        both = ma & mc
        dp = (a.rigid_contact_position.cpu() - c.rigid_contact_position
              ).abs().amax(-1)
        per_world = (ma != mc).view(n, -1).any(1) if not pipe_kw else None
        rows.append(dict(
            mask_slots_differ=int((ma != mc).sum()),
            mask_worlds_differ=None if per_world is None
            else int(per_world.sum()),
            point_move_max=float(dp[both].max()) if bool(both.any())
            else 0.0,
            body_q=float((s_d[i].body_q.cpu() - s_c[i].body_q).abs().max()),
            body_qd=float((s_d[i].body_qd.cpu() - s_c[i].body_qd).abs()
                          .max())))
    out["card_vs_cpu"] = rows
    base = run("cpu", gated.to("cpu"))[1][-1]
    spread = []
    for seed in range(8):
        g = torch.Generator().manual_seed(seed)
        s2 = gated.to("cpu")
        sign = torch.randint(0, 2, s2.body_q.shape, generator=g) * 2.0 - 1.0
        s2.body_q = torch.nextafter(s2.body_q, s2.body_q + sign)
        e = run("cpu", s2)[1][-1]
        spread.append(dict(
            body_q=float((e.body_q - base.body_q).abs().max()),
            body_qd=float((e.body_qd - base.body_qd).abs().max())))
    out["cpu_one_ulp_spread"] = spread
    out["ops_that_differ"] = op_diffs(
        lambda: solver.step(gated, None, None, pipe.collide(gated), dt))
    return out


def main(argv):
    import torch
    import chip_smoke as cs
    import newton_tpu_torch as nt
    if not torch.cuda.is_available():
        print("device_op_diff: no CUDA device", file=sys.stderr)
        return 2
    n = 64
    if "--worlds" in argv:
        k = argv.index("--worlds")
        n = int(argv[k + 1])
        argv = argv[:k] + argv[k + 2:]
    print(torch.cuda.get_device_name(0), cs.card_line(), flush=True)
    results = []
    for name in argv or ["cone"]:
        r = study(cs, nt, name, n if name != "pile" else min(n, 8))
        print(json.dumps(r), flush=True)
        results.append(r)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "device_op_diff.json"),
              "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
