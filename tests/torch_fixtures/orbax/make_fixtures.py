"""Write the orbax workspaces that the port's checkpoint reader is held
against where there is no JAX (the card's machine), with the JAX
package's own CLI, and record the sha256 of every leaf as the JAX
package restores it.

    JAX_PLATFORMS=cpu python tests/torch_fixtures/orbax/make_fixtures.py

from the root of a checkout with `orbax.checkpoint` importable.  It
replaces `lm_tiny/`, `conv/` and `hashes.json` beside this file:

- `lm_tiny/`: `examples/transformer/lm_tiny.conf`, 8 synthetic steps
  (Adam), the CLI's orbax step 8.
- `conv/`: `examples/mnist/conv.conf` at its shipped width (LeNet,
  kSGD with momentum), 4 synthetic steps, saved at step 4 by a copy of
  the config that adds `checkpoint_frequency: 4` (the shipped config
  saves no checkpoint).
- `hashes.json`: per workspace, its step and, per leaf (`|`-joined key
  path), the dtype, shape and sha256 of the C-ordered bytes of the
  leaf as `singa_tpu.utils.checkpoint.CheckpointManager.restore`
  returns it, bf16 leaves widened to float32 (as the port returns
  them).
"""

import hashlib
import json
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

import singa_tpu.main as jmain  # noqa: E402
import singa_tpu.utils.checkpoint as jckpt  # noqa: E402


def leaf_digest(arr) -> dict:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    arr = np.ascontiguousarray(arr)
    return {"dtype": arr.dtype.str, "shape": list(arr.shape),
            "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}


def flat(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from flat(tree[k], f"{prefix}{k}|")
        else:
            yield f"{prefix}{k}", tree[k]


def write(name: str, conf: str, steps: int) -> dict:
    ws = os.path.join(HERE, name)
    shutil.rmtree(ws, ignore_errors=True)
    assert jmain.main(["-model_conf", conf, "--synthetic", "--steps",
                       str(steps), "--workspace", ws]) == 0
    ckpt = os.path.join(ws, "checkpoints")
    assert os.listdir(ckpt) and not any(f.endswith(".npz")
                                        for f in os.listdir(ckpt))
    params, opt, step = jckpt.CheckpointManager(
        ws, log_fn=lambda s: None).restore()
    state = {"params": params, "opt_state": opt}
    return {"step": int(step),
            "leaves": {k: leaf_digest(v) for k, v in flat(state)}}


def main() -> None:
    assert jckpt._HAVE_ORBAX, "orbax.checkpoint must import"
    out = {"lm_tiny": write(
        "lm_tiny", os.path.join(REPO, "examples", "transformer",
                                "lm_tiny.conf"), 8)}
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(REPO, "examples", "mnist", "conv.conf")
        conf = os.path.join(tmp, "conv.conf")
        with open(src) as f:
            text = f.read()
        with open(conf, "w") as f:
            f.write(text.replace("train_steps: 10000",
                                 "train_steps: 10000\ncheckpoint_frequency: 4",
                                 1))
        out["conv"] = write("conv", conf, 4)
    with open(os.path.join(HERE, "hashes.json"), "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
