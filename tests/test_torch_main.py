"""The port's CLI (`singa_tpu_torch/main.py`): `serve --smoke N` on the
CPU through `main(argv, device="cpu")` against the JAX package's
`serve_main` on the same config and workspace — both return 0, serve
the same checkpoint step and print snapshots with the same keys and
counts — and the exits of what the port does not have yet: the fleet
flags (2, naming ROADMAP.md A11) and every other subcommand (2, naming
A10).  On a machine without a card the CLI raises rather than running
on the CPU."""

import json
import os

import numpy as np
import pytest
import torch

import singa_tpu.main as jmain
import singa_tpu.utils.checkpoint as jckpt

import singa_tpu_torch.main as tmain
from singa_tpu_torch.config import load_model_config
from singa_tpu_torch.core.net import build_net
from singa_tpu_torch.utils.checkpoint import CheckpointManager
from singa_tpu_torch.weights import numpy_params

pytestmark = pytest.mark.port
CONF = os.path.join(os.path.dirname(__file__), "..", "examples",
                    "transformer", "lm_tiny.conf")
# the counts that do not depend on timing (cb_steps counts scheduler
# iterations, which do)
COUNTS = ("submitted", "completed", "failed", "generated_tokens",
          "batches", "params_step")


def _last_json(out: str):
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("spec", [
    "buckets=1x8/2x16,max_new_tokens=4",
    "buckets=2x16,max_new_tokens=4,cb=on,cb_slots=2,cb_block_len=4",
])
def test_serve_smoke_matches_the_jax_cli(spec, tmp_path, capsys,
                                         monkeypatch):
    monkeypatch.setattr(jckpt, "_HAVE_ORBAX", False)
    net = build_net(load_model_config(CONF), "kTrain",
                    {"data": {"input": (16,), "target": (16,)}})
    CheckpointManager(str(tmp_path)).save(
        3, numpy_params(net, seed=4), {"t": np.zeros((), np.float32)})
    argv = ["serve", "-model_conf", CONF, "--workspace", str(tmp_path),
            "--serve_spec", spec, "--smoke", "3"]
    assert tmain.main(argv, device="cpu") == 0
    got = _last_json(capsys.readouterr().out)
    assert jmain.main(argv) == 0
    want = _last_json(capsys.readouterr().out)
    assert set(got) == set(want)
    assert {k: got[k] for k in COUNTS} == {k: want[k] for k in COUNTS}
    assert got["params_step"] == 3 and got["completed"] == 3


@pytest.mark.parametrize("argv,item", [
    (["serve", "-model_conf", CONF, "--fleet", "2"], "A11"),
    (["serve", "-model_conf", CONF, "--fleet_hostfile", "h"], "A11"),
    (["serve", "-model_conf", CONF, "--standby"], "A11"),
    (["serve", "-model_conf", CONF, "--autoscale_spec", "slo_p95_ms=9"],
     "A11"),
    (["pipeline", "-model_conf", CONF, "--workspace", "ws"], "A10"),
    (["-model_conf", CONF], "A10"),
    ([], "A10"),
])
def test_what_the_port_lacks_exits_2_naming_the_roadmap_item(
        argv, item, capsys):
    assert tmain.main(argv, device="cpu") == 2
    assert f"ROADMAP.md {item}" in capsys.readouterr().err


def test_the_cli_runs_on_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; the no-card "
                    "behaviour is checked where there is none")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmain.main(["serve", "-model_conf", CONF, "--smoke", "1"])
