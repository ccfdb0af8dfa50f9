"""Write the orbax workspaces that the port's checkpoint reader is held
against where there is no JAX (the card's machine), with the JAX
package's own CLI, and record the sha256 of every leaf as the JAX
package restores it.

    JAX_PLATFORMS=cpu python tests/torch_fixtures/orbax/make_fixtures.py

from the root of a checkout with `orbax.checkpoint` importable.  It
replaces `lm_tiny/`, `conv/`, `lm_tiny_tp2/` and their entries in
`hashes.json` beside this file (name some of them as arguments to
replace only those):

- `lm_tiny/`: `examples/transformer/lm_tiny.conf`, 8 synthetic steps
  (Adam), the CLI's orbax step 8.
- `conv/`: `examples/mnist/conv.conf` at its shipped width (LeNet,
  kSGD with momentum), 4 synthetic steps, saved at step 4 by a copy of
  the config that adds `checkpoint_frequency: 4` (the shipped config
  saves no checkpoint).
- `lm_tiny_tp2/`: `lm_tiny.conf` under `tensor_parallel: 2`, trained
  2 synthetic steps by the JAX CLI on 2 processes on the CPU (one
  device each, `-hostfile` and `-procsID`): a step written by several
  processes, whose model-sharded leaves are split between
  `default/ocdbt.process_0/` and `default/ocdbt.process_1/`.  The CLI
  runs with `--health off`: with a verdict to record, both processes
  write `MANIFEST.json` through one temporary name, and one of them
  fails.
- `hashes.json`: per workspace, its step and, per leaf (`|`-joined key
  path), the dtype, shape and sha256 of the C-ordered bytes of the
  leaf as `singa_tpu.utils.checkpoint.CheckpointManager.restore`
  returns it, bf16 leaves widened to float32 (as the port returns
  them).  `lm_tiny_tp2`'s step is restored with the JAX trainer's own
  tree as the template, as its CLI's `--resume` restores it: a
  templateless restore needs the devices it was saved from.
"""

import hashlib
import json
import os
import shutil
import socket
import subprocess
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


def write_two_processes(name: str, conf: str, steps: int) -> dict:
    ws = os.path.join(HERE, name)
    shutil.rmtree(ws, ignore_errors=True)
    with tempfile.TemporaryDirectory() as tmp:
        cluster = os.path.join(tmp, "tp2.conf")
        with open(cluster, "w") as f:
            f.write("tensor_parallel: 2\n")
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        hostfile = os.path.join(tmp, "hostfile")
        with open(hostfile, "w") as f:
            f.write(f"127.0.0.1:{port}\nlocalhost\n")
        env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO,
                   XLA_FLAGS="--xla_force_host_platform_device_count=1")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "singa_tpu.main", "-model_conf", conf,
             "-cluster_conf", cluster, "--synthetic", "--steps", str(steps),
             "--workspace", ws, "--health", "off", "-hostfile", hostfile,
             "-procsID", str(i)], cwd=REPO, env=env) for i in range(2)]
        assert [p.wait(600) for p in procs] == [0, 0]
    step = os.path.join(ws, "checkpoints", str(steps), "default")
    assert os.path.isdir(os.path.join(step, "ocdbt.process_1"))
    import singa_tpu.main  # noqa: F401  (the JAX trainer, as main runs it)
    from singa_tpu.config import load_model_config
    from singa_tpu.core.trainer import Trainer
    from singa_tpu.data import discover_input_shapes
    model = load_model_config(conf)
    tr = Trainer(model, discover_input_shapes(model, force_synthetic=True),
                 log_fn=lambda s: None)
    p0, o0 = tr.init(0)
    params, opt, got = jckpt.CheckpointManager(
        ws, log_fn=lambda s: None).restore(
        template={"params": p0, "opt_state": o0})
    assert got == steps, got
    state = {"params": params, "opt_state": opt}
    return {"step": int(got),
            "leaves": {k: leaf_digest(v) for k, v in flat(state)}}


def main(names) -> None:
    assert jckpt._HAVE_ORBAX, "orbax.checkpoint must import"
    lm_tiny = os.path.join(REPO, "examples", "transformer", "lm_tiny.conf")
    path = os.path.join(HERE, "hashes.json")
    out = {}
    if os.path.exists(path):
        with open(path) as f:
            out = json.load(f)
    names = names or ["lm_tiny", "conv", "lm_tiny_tp2"]
    if "lm_tiny" in names:
        out["lm_tiny"] = write("lm_tiny", lm_tiny, 8)
    if "conv" in names:
        with tempfile.TemporaryDirectory() as tmp:
            src = os.path.join(REPO, "examples", "mnist", "conv.conf")
            conf = os.path.join(tmp, "conv.conf")
            with open(src) as f:
                text = f.read()
            with open(conf, "w") as f:
                f.write(text.replace(
                    "train_steps: 10000",
                    "train_steps: 10000\ncheckpoint_frequency: 4", 1))
            out["conv"] = write("conv", conf, 4)
    if "lm_tiny_tp2" in names:
        out["lm_tiny_tp2"] = write_two_processes("lm_tiny_tp2", lm_tiny, 2)
    with open(path, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main(sys.argv[1:])
