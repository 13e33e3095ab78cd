"""One phase of ``chip_smoke.py`` against two checkouts of the port, in turns
(baseline, this tree, this tree, baseline), each turn in a process of its
own: the same measurement code drives both packages, so a change to the
package alone shows in the phase's readings.

    python -m tpu_compressed_dp_torch.harness.phase_turns --baseline DIR \\
        [--phase phase_steady_imagenet] [--out FILE]

``DIR`` is a checkout of the port; its ``tpu_compressed_dp_torch/`` is the
package of the baseline's turns, and it builds its own kernels.  This
tree's ``chip_smoke.py`` is loaded in every turn and its function
``--phase`` is called with whichever of ``kernels``, ``compressors``,
``wire``, ``dawn``, ``imagenet``, ``torch`` and ``record`` it names, as
``chip_smoke.main`` passes them, with TF32 off (as from the script's phase
4 on).  Each turn's record, with the card's name and power limit, goes to
``--out`` (default ``build/phase_turns.json``).  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TURNS = ("baseline", "this", "this", "baseline")

# a turn: the tree's package first on the path, this tree's chip_smoke.py
_WORKER = r"""
import importlib.util, inspect, json, sys
tree, smoke, phase, out = sys.argv[1:5]
sys.path.insert(0, tree)
import torch
from tpu_compressed_dp_torch.harness import dawn, imagenet
from tpu_compressed_dp_torch.ops import compressors, kernels, wire
spec = importlib.util.spec_from_file_location("chip_smoke", smoke)
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
kernels.build()
record = {"card": cs.nvidia_smi()}
have = dict(kernels=kernels, compressors=compressors, wire=wire, dawn=dawn,
            imagenet=imagenet, torch=torch, record=record)
fn = getattr(cs, phase)
fn(**{name: have[name] for name in inspect.signature(fn).parameters})
json.dump(record, open(out, "w"))
"""


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--baseline", required=True, help="a checkout of the port")
    p.add_argument("--phase", default="phase_steady_imagenet",
                   help="a phase function of chip_smoke.py")
    p.add_argument("--out", default=os.path.join("build", "phase_turns.json"))
    args = p.parse_args(argv)
    trees = {"baseline": os.path.abspath(args.baseline), "this": HERE}
    smoke = os.path.join(HERE, "chip_smoke.py")
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    turns = []
    for i, which in enumerate(TURNS):
        path = os.path.join(out_dir, f"phase_turns_{i}.json")
        res = subprocess.run([sys.executable, "-c", _WORKER, trees[which], smoke, args.phase,
                              path], cwd=trees[which], capture_output=True, text=True)
        print(f"turn {i} ({which}):\n{res.stdout}", flush=True)
        if res.returncode:
            print(res.stderr[-4000:], file=sys.stderr)
            return 1
        with open(path) as f:
            turns.append({"turn": i, "tree": which, "record": json.load(f)})
        os.remove(path)
    with open(args.out, "w") as f:
        json.dump({"phase": args.phase, "baseline": trees["baseline"], "turns": turns}, f,
                  indent=1)
    print(json.dumps({"phase": args.phase, "out": args.out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
