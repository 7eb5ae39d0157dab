"""Time the ``--fused-block`` CLI paths of two checkouts on one card, in
turns (A, B, B, A), so that a change to K5 can be read end to end.

    python3 tools/fused_path_check.py TREE_A TREE_B

In one fresh data directory: ``cifar_unet init`` and the synthesized CIFAR
batches (from TREE_A), then per tree and turn, each in a subprocess run in
that tree: ``run 1 --fused-block`` (the verb's wall time) and ``train 1
--fused-block --max-steps=30`` from a fresh train state (wall time and the
epoch's images/s). Each subprocess builds its tree's kernels before the
timed verb. Prints one line per run and the card's name and power limit.
"""

import json
import os
import subprocess
import sys
import tempfile

# One timed verb in the tree it runs in (argv[1]: "run" or "train").
RUN_ONE = r'''
import contextlib, io, json, os, re, shutil, sys, time
import torch
from big_linear_algebra_tpu_torch.models import cifar_unet as cu
from big_linear_algebra_tpu_torch.ops import cuda_utils
names = sorted(p.stem for p in cuda_utils.CSRC.glob("*.cu"))
cuda_utils.build(names)
for name in names:
    cuda_utils.load_library(name)
if sys.argv[1] == "train":
    shutil.rmtree(os.path.join(os.environ["BLA_DATA_DIR"], "cifar_unet",
                               "train_state_torch"), ignore_errors=True)
    args = ["train", "1", "--fused-block", "--max-steps=30"]
else:
    args = ["run", "1", "--fused-block", "--sample-seed=0"]
out = io.StringIO()
t0 = time.perf_counter()
with contextlib.redirect_stdout(out):
    rc = cu.main(args)
torch.cuda.synchronize()
wall = time.perf_counter() - t0
rate = re.findall(r"images_per_sec: ([0-9.]+)", out.getvalue())
print(json.dumps({"rc": rc, "wall_s": wall,
                  "images_per_sec": float(rate[0]) if rate else None}))
'''

PREPARE = r'''
import os
from big_linear_algebra_tpu_torch.data import synth
from big_linear_algebra_tpu_torch.models import cifar_unet as cu
assert cu.main(["init"]) == 0
synth.ensure_cifar(os.environ["BLA_DATA_DIR"])
'''


def _python(tree: str, code: str, *args: str, env: dict) -> str:
    done = subprocess.run([sys.executable, "-c", code, *args], cwd=tree,
                          env=dict(env, PYTHONPATH=tree), capture_output=True,
                          text=True, timeout=900)
    if done.returncode != 0:
        print(f"FAIL: {tree} {args}: exit {done.returncode}\n{done.stdout}"
              f"{done.stderr}", flush=True)
        raise SystemExit(1)
    return done.stdout


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__)
        return 2
    trees = [os.path.abspath(t) for t in sys.argv[1:]]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    with tempfile.TemporaryDirectory(prefix="bla_fused_") as tmp:
        env = dict(os.environ, BLA_DATA_DIR=tmp)
        _python(trees[0], PREPARE, env=env)
        for turn, tree in enumerate(trees + trees[::-1]):
            for verb in ("run", "train"):
                got = json.loads(_python(tree, RUN_ONE, verb,
                                         env=env).splitlines()[-1])
                if got["rc"] != 0:
                    print(f"FAIL: {tree} {verb} exited {got['rc']}")
                    return 1
                rate = got["images_per_sec"]
                print(f"[fused path] turn {turn} {tree}: {verb} 1 "
                      f"--fused-block {got['wall_s']:.2f} s wall"
                      + (f", {rate} images/s" if rate else ""), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
