"""Example framework: CLI parsing, viewer construction, run loop (port of
``newton_tpu/examples/__init__.py``).

Examples are classes with ``__init__(viewer, args)`` / ``step()`` /
``render()`` / ``test_final()``; ``python -m newton_tpu_torch.examples
<name> --viewer null --num-frames 100`` runs one headlessly, as the
reference's CLI does. ``--device`` is a torch device, the card by default:
it goes to ``ModelBuilder.finalize``, which raises where CUDA is absent
(pass ``--device cpu`` to run on the CPU). ``EXAMPLES`` lists the examples
this package has ported; the JAX package's others follow in later work.
"""

from __future__ import annotations

import argparse
import importlib
import sys
import time

__all__ = ["EXAMPLES", "create_parser", "init", "run", "browse", "main",
           "device_of"]

EXAMPLES = {
    "robot_humanoid_batch":
        "newton_tpu_torch.examples.example_robot_humanoid_batch",
    "robot_ant": "newton_tpu_torch.examples.example_robot_ant",
    "robot_cartpole": "newton_tpu_torch.examples.example_robot_cartpole",
    "robot_cheetah": "newton_tpu_torch.examples.example_robot_cheetah",
    "robot_walker2d": "newton_tpu_torch.examples.example_robot_walker2d",
    "robot_policy": "newton_tpu_torch.examples.example_robot_policy",
    "robot_arm_reach": "newton_tpu_torch.examples.example_robot_arm_reach",
    "terrain_ant": "newton_tpu_torch.examples.example_terrain_ant",
    "tendon_finger": "newton_tpu_torch.examples.example_tendon_finger",
    "controller_impedance_hetero":
        "newton_tpu_torch.examples.example_controller_impedance_hetero",
    "mpm_sand": "newton_tpu_torch.examples.example_mpm_sand",
    "mpm_granular": "newton_tpu_torch.examples.example_mpm_granular",
    "mpm_multi_material":
        "newton_tpu_torch.examples.example_mpm_multi_material",
    "mpm_snow_ball": "newton_tpu_torch.examples.example_mpm_snow_ball",
    "mpm_viscous": "newton_tpu_torch.examples.example_mpm_viscous",
    "mpm_beam_twist": "newton_tpu_torch.examples.example_mpm_beam_twist",
}


def device_of(args) -> str:
    """The torch device an example builds its model on: ``args.device``,
    else the card."""
    return getattr(args, "device", None) or "cuda"


def create_parser() -> argparse.ArgumentParser:
    """CLI matching the reference (examples/__init__.py:790-880)."""
    p = argparse.ArgumentParser(prog="newton_tpu_torch.examples")
    p.add_argument("example", nargs="?", choices=sorted(EXAMPLES),
                   help="example to run")
    p.add_argument("--viewer", default="null",
                   choices=["null", "file", "gl", "rtx", "rerun", "viser",
                            "usd"],
                   help="viewer backend")
    p.add_argument("--num-frames", type=int, default=100)
    p.add_argument("--device", default="cuda",
                   help="torch device of the model (default: the card; "
                        "cpu runs on the CPU)")
    p.add_argument("--num-worlds", type=int, default=4)
    p.add_argument("--output", default="recording.json",
                   help="output path for --viewer file")
    p.add_argument("--test", action="store_true",
                   help="run test_final() after the frames")
    p.add_argument("--benchmark", action="store_true",
                   help="print fps at the end")
    return p


def init(argv=None):
    """Parse args and build the viewer (reference: examples/__init__.py:867)."""
    args = create_parser().parse_args(argv)
    from .. import viewer as v
    if args.viewer == "file":
        viewer = v.ViewerFile(args.output)
    elif args.viewer == "usd":
        viewer = v.ViewerUSD(args.output if args.output != "recording.json"
                             else "recording.usda")
    elif args.viewer == "null":
        viewer = v.ViewerNull(max_frames=args.num_frames)
    else:
        viewer = getattr(v, {"gl": "ViewerGL", "rtx": "ViewerRTX",
                             "rerun": "ViewerRerun",
                             "viser": "ViewerViser"}[args.viewer])()
    return viewer, args


def _finite(x) -> bool:
    import torch
    return bool(torch.isfinite(x).all()) if isinstance(x, torch.Tensor) \
        else True


def run(example, args, viewer=None):
    """Main loop (reference: examples/__init__.py:521-600)."""
    viewer = viewer or getattr(example, "viewer", None)
    frames = 0
    t0 = time.perf_counter()
    while viewer is None or viewer.is_running():
        if viewer is None or getattr(viewer, "wants_step", True):
            example.step()
        if hasattr(example, "render"):
            example.render()
        frames += 1
        if frames >= args.num_frames:
            break
    elapsed = time.perf_counter() - t0

    if args.test and hasattr(example, "test_final"):
        example.test_final()
        # NaN sweep over state (reference :587-600)
        state = getattr(example, "state", None) or getattr(
            example, "state_0", None)
        if state is not None:
            for name in ("body_q", "body_qd", "particle_q", "joint_q"):
                assert _finite(getattr(state, name)), f"NaN/Inf in {name}"
        print("test passed")
    if args.benchmark:
        print(f"frames: {frames}  fps: {frames / max(elapsed, 1e-9):.1f}")
    if viewer is not None:
        viewer.close()


def browse(argv=None):
    """Interactive example browser (reference: examples/__init__.py:521
    browse loop): groups examples by prefix, prompts for a number or name,
    runs the pick, then returns to the list. 'q' exits."""
    names = sorted(EXAMPLES)
    groups = {}
    for n in names:
        groups.setdefault(n.split("_", 1)[0], []).append(n)
    while True:
        print("\nnewton_tpu_torch examples\n" + "=" * 25)
        num = {}
        i = 1
        for gname in sorted(groups):
            print(f"\n[{gname}]")
            for n in groups[gname]:
                num[str(i)] = n
                print(f"  {i:3d}. {n}")
                i += 1
        try:
            pick = input("\nrun which example? (number/name, q to quit) "
                         ).strip()
        except EOFError:
            return 0
        if pick in ("q", "quit", "exit", ""):
            return 0
        name = num.get(pick, pick)
        if name not in EXAMPLES:
            print(f"unknown example {pick!r}")
            continue
        try:
            main([name] + list(argv or []))
        except KeyboardInterrupt:
            print("\n(interrupted)")
        except Exception as e:                          # noqa: BLE001
            print(f"example {name} failed: {e}")


def main(argv=None):
    parser = create_parser()
    args, _ = parser.parse_known_args(argv)
    if not args.example:
        if sys.stdin is not None and sys.stdin.isatty():
            return browse(argv)
        parser.print_help()
        return 1
    module = importlib.import_module(EXAMPLES[args.example])
    viewer, args = init(argv)
    example = module.Example(viewer, args)
    run(example, args, viewer)
    return 0
