"""The PyTorch port stands alone: importing every module of
`singa_tpu_torch` loads neither JAX nor the JAX package, no import
statement in it names them, and its entry points run on CUDA unless the
caller asks for the CPU — they raise, rather than fall back, where there
is no card."""

import ast
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import singa_tpu_torch
from singa_tpu_torch.core.net import build_net
from singa_tpu_torch.core.trainer import Trainer
from singa_tpu_torch.models.generate import init_cache
from singa_tpu_torch.models.transformer import transformer_lm
from singa_tpu_torch.serve.engine import InferenceEngine, ServeSpec
from singa_tpu_torch.serve.kvcache import PagedKVCache, init_pools
from singa_tpu_torch.weights import numpy_params, params_from_numpy

pytestmark = pytest.mark.port
PKG_DIR = os.path.dirname(singa_tpu_torch.__file__)
REPO = os.path.dirname(PKG_DIR)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [PKG_DIR], prefix="singa_tpu_torch."))


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "singa_tpu")


def test_importing_every_module_loads_no_jax():
    mods = _modules()
    assert "singa_tpu_torch.ops._kernels" in mods
    assert "singa_tpu_torch.core.step_graph" in mods
    for m in ("serve.batcher", "serve.kvcache", "serve.qos",
              "serve.scheduler", "serve.stats", "serve.tenancy",
              "utils.faults", "ops.moe", "ops.topk", "serve.server",
              "serve.wire", "serve.router", "obs", "obs.perf",
              "obs.trace", "obs.flightrec", "data.discovery", "main",
              "utils.health", "core.supervisor", "data.records",
              "data.shard", "data.native", "data.lmdb_reader",
              "data.pipeline", "data.feed", "ops.augment", "models.rbm",
              "utils.flops", "utils.profiler", "tools.viz",
              "tools.export_examples", "tools.convergence_run",
              "tools.loader", "serve.session", "serve.sessionlog",
              "serve.fleet", "serve.autoscale", "serve.traffic",
              "obs.collect", "parallel.bootstrap", "tools.walcheck",
              "tools.trace_timeline", "parallel.elastic", "core.pipeline",
              "parallel.pipeline", "parallel.pipeline_net"):
        assert f"singa_tpu_torch.{m}" in mods, m
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'singa_tpu'))\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_no_import_statement_names_jax_or_the_jax_package():
    bad = []
    for root, _, files in os.walk(PKG_DIR):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            with open(path) as fh:
                tree = ast.parse(fh.read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module or ""]
                else:
                    continue
                bad += [(path, n) for n in names if _forbidden(n)]
    assert not bad, bad


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; the no-card "
                    "behaviour is checked where there is none")
    cfg = transformer_lm(vocab_size=256, num_layers=1, embed_dim=32,
                         num_heads=2, head_dim=16, seq_len=16, batchsize=2)
    shapes = {"data": {"input": (16,), "target": (16,)}}
    net = build_net(cfg, "kTrain", shapes)
    arrays = numpy_params(net, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy(net, arrays)
    with pytest.raises(RuntimeError, match="CUDA"):
        net.init_params(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_cache(net, 2, 8)
    params = params_from_numpy(net, arrays, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(net, ServeSpec(), params)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(net, ServeSpec(), workspace="unused")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_pools(net, 4, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedKVCache(net, 1, 2, 4, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, shapes)
    # asked for the CPU, the same calls run there
    assert net.init_params(0, device="cpu")["embed/embedding"].device.type \
        == "cpu"
    eng = InferenceEngine(net, ServeSpec(buckets=((2, 4),),
                                         max_new_tokens=2), params,
                          device="cpu")
    out = eng.run_batch("generate", np.ones((2, 4), np.int32),
                        np.array([4, 2], np.int32))
    assert out.shape == (2, 2)
    trainer = Trainer(cfg, shapes, device="cpu")
    p, opt = trainer.init(0)
    batch = {"data": {"input": np.ones((2, 16), np.int32),
                      "target": np.ones((2, 16), np.int32)}}
    _, _, metrics = trainer.train_step(p, opt, batch, 0)
    assert p["embed/embedding"].device.type == "cpu"
    assert np.isfinite(float(metrics["loss"]))
