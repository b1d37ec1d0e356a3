#!/usr/bin/env python3
"""Run chosen chip_smoke.py phases alone on the card and print each
one's seconds and results as a JSON line.

    python3 tools/chip_phases.py 24 25 26 27   # on a machine with a GPU
    python3 tools/chip_phases.py 28 29 30 31 --tests tests/test_torch_determinism.py
    python3 tools/chip_phases.py 32 33 34 35 36
    python3 tools/chip_phases.py 37 38 39 40 41 43
    python3 tools/chip_phases.py 43 45 46 48
    python3 tools/chip_phases.py 49 50 51
    python3 tools/chip_phases.py 52 53 --tests tests/test_torch_avbd.py tests/test_torch_coupled.py
    python3 tools/chip_phases.py 54 55
    python3 tools/chip_phases.py 59         # the USD ant x 4096
    python3 tools/chip_phases.py 60 --tests tests/test_torch_examples.py

Phases 21-55, 59 and 60 (the examples: the humanoid batch x 4096
through the registry, every other ported example, the CLI) are the ones that take only the device (``dev``; 41 runs
41 and 42, 43 runs 43 and 44, 46 runs 46 and 47, 40 times Style3D beside
XPBD); the CUDA kernels are built first when a phase launches them (22,
29-39, 48-50, 52-54, 59, 60). With
``--tests``, the GPU cases of the named test files run afterwards
(``pytest -m gpu``). Writes the results to chiprun_out/phases.json too.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PHASES = {"21": "phase_ant_xpbd", "22": "phase_pyramid",
          "23": "phase_domino", "24": "phase_cloth_style3d",
          "25": "phase_garment", "26": "phase_vbd",
          "27": "phase_semi_implicit", "28": "phase_ik",
          "29": "phase_warm_sleep", "30": "phase_equality",
          "31": "phase_urdf", "32": "phase_newton_qp",
          "33": "phase_implicit", "34": "phase_tendons",
          "35": "phase_muscles", "36": "phase_kamino",
          "37": "phase_conveyor", "38": "phase_mounted",
          "39": "phase_tower", "40": "phase_xpbd_cloth",
          "41": "phase_xpbd_particles", "43": "phase_cables",
          "45": "phase_shapes", "46": "phase_pile_sap",
          "48": "phase_manifolds", "49": "phase_terrain",
          "50": "phase_mesh_scenes", "51": "phase_pile_hulls",
          "52": "phase_vbd_rigid", "53": "phase_coupled",
          "54": "phase_policy_ant", "55": "phase_franka",
          "59": "phase_usd_ant", "60": "phase_examples"}
KERNEL_PHASES = {"22", "29", "30", "31", "32", "33", "34", "35", "36",
                 "37", "38", "39", "48", "49", "50", "52", "53", "54",
                 "59", "60"}


def main(argv):
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("chip_phases: no CUDA device", file=sys.stderr)
        return 2
    tests = []
    if "--tests" in argv:
        k = argv.index("--tests")
        argv, tests = argv[:k], argv[k + 1:]
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(torch.cuda.get_device_name(0), cs.card_line(), flush=True)
    if KERNEL_PHASES & set(argv):
        from newton_tpu_torch import _kernels
        t0 = time.perf_counter()
        _kernels.lib()
        print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    out, failed = {}, 0
    for name in argv:
        t0 = time.perf_counter()
        try:
            out[name] = getattr(cs, PHASES[name])(dev)
        except Exception as e:          # report every phase, then fail
            import traceback
            traceback.print_exc()
            out[name], failed = repr(e), failed + 1
        print(f"[{name}] {time.perf_counter() - t0:.1f} s "
              + json.dumps(out[name], default=str), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "phases.json"), "w") as f:
        json.dump(out, f, default=str, indent=1)
    if tests:
        r = subprocess.run([sys.executable, "-m", "pytest", "-o", "addopts=",
                            "--noconftest", "-m", "gpu", "-q"] + tests,
                           cwd=ROOT)
        failed += r.returncode != 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
