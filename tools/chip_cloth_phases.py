#!/usr/bin/env python3
"""Run chip_smoke.py's cloth phases (24-27) alone on the card and print
each one's seconds and results as a JSON line.

    python3 tools/chip_cloth_phases.py        # on a machine with a GPU

The phases build no kernel (no TPU kernel lies on the cloth path), so
this skips chip_smoke.py's build and its phases 1-23.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("chip_cloth_phases: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(torch.cuda.get_device_name(0), cs.card_line(), flush=True)
    for name, fn in (("24", cs.phase_cloth_style3d),
                     ("25", cs.phase_garment), ("26", cs.phase_vbd),
                     ("27", cs.phase_semi_implicit)):
        t0 = time.perf_counter()
        r = fn(dev)
        print(f"[{name}] {time.perf_counter() - t0:.1f} s "
              + json.dumps(r, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
