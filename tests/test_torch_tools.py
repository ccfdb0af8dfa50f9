"""The port's tools (`singa_tpu_torch/tools/`) against the JAX package's
(`singa_tpu/tools/`): `viz` (dot text, parsed logs, plotted curves),
`export_examples` (the configs from each zoo), `loader` (every mode
writes byte-equal shards from the same idx, CIFAR, image-folder and
LMDB inputs), a short `convergence_run` on the CPU, and the engine's
`harvest_costs` (CostWatch) on the CPU."""

import os
import struct

import numpy as np
import pytest

from singa_tpu.config import load_model_config as jload
from singa_tpu.core.net import build_net as jbuild
from singa_tpu.tools import export_examples as jexport
from singa_tpu.tools import loader as jloader
from singa_tpu.tools import viz as jviz

from singa_tpu_torch.config import load_model_config
from singa_tpu_torch.core.net import build_net
from singa_tpu_torch.data.records import Datum
from singa_tpu_torch.models.transformer import transformer_lm
from singa_tpu_torch.obs import perf
from singa_tpu_torch.serve.engine import InferenceEngine, ServeSpec
from singa_tpu_torch.tools import convergence_run
from singa_tpu_torch.tools import export_examples
from singa_tpu_torch.tools import loader
from singa_tpu_torch.tools import viz
from singa_tpu_torch.weights import numpy_params, params_from_numpy

from lmdb_fixture import write_lmdb

pytestmark = pytest.mark.port
EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
MNIST_SHAPES = {"data": {"pixel": (28, 28), "label": ()}}
LOG = ("step-0: loss : 2.301234, precision : 0.101562\n"
       "junk line\n"
       "step-30 test: loss : 2.100000, precision : 0.301000\n"
       "step-30: loss : 1.900111, precision : 0.401222\n"
       "step-40 validation: loss : 1.8, precision : 0.5\n")


def test_viz_equals_the_jax_packages(tmp_path):
    conf = os.path.join(EXAMPLES, "mnist", "conv.conf")
    net = build_net(load_model_config(conf), "kTrain", MNIST_SHAPES,
                    batchsize=2)
    jnet = jbuild(jload(conf), "kTrain", MNIST_SHAPES, batchsize=2)
    dot = viz.json_to_dot(net.to_json(), name="lenet")
    assert dot == jviz.json_to_dot(jnet.to_json(), name="lenet")
    assert '"conv1" -> "pool1";' in dot
    assert viz.parse_training_log(LOG) == jviz.parse_training_log(LOG)
    assert viz.parse_training_log(LOG)["validation"]["loss"] == [1.8]
    got = viz.plot_training_log(LOG, str(tmp_path / "port.png"))
    want = jviz.plot_training_log(LOG, str(tmp_path / "jax.png"))
    assert got == want == ["loss", "precision"]
    assert (tmp_path / "port.png").read_bytes() == \
        (tmp_path / "jax.png").read_bytes()
    net_json = tmp_path / "net.json"
    net_json.write_text(net.to_json())
    assert viz.main(["dot", str(net_json), str(tmp_path / "n.dot")]) == 0
    assert (tmp_path / "n.dot").read_text() == jviz.json_to_dot(
        jnet.to_json())
    assert viz.main([]) == 2


def test_export_examples_equal_the_jax_packages(tmp_path):
    assert list(export_examples.EXAMPLES) == list(jexport.EXAMPLES)
    export_examples.main(["--outdir", str(tmp_path / "port")])
    jexport.main(["--outdir", str(tmp_path / "jax")])
    for rel in jexport.EXAMPLES:
        got = (tmp_path / "port" / rel).read_text()
        assert got == (tmp_path / "jax" / rel).read_text(), rel
        # and each is the shipped example
        with open(os.path.join(EXAMPLES, rel)) as f:
            assert load_model_config(str(tmp_path / "port" / rel)) == \
                load_model_config(os.path.join(EXAMPLES, rel)), rel


def _folder_bytes(folder) -> dict:
    out = {}
    for root, _, files in os.walk(folder):
        for f in files:
            path = os.path.join(root, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, folder)] = fh.read()
    assert out, folder
    return out


def _both(tmp_path, name, argv_of):
    """Run one loader command line through both packages, each into its
    own output under tmp_path; returns the two output paths."""
    outs = []
    for pkg, main in (("port", loader.main), ("jax", jloader.main)):
        out = str(tmp_path / pkg / name)
        os.makedirs(os.path.dirname(out), exist_ok=True)
        assert main(argv_of(out)) == 0
        outs.append(out)
    return outs


def _idx(tmp_path, n=23):
    rng = np.random.default_rng(5)
    images = tmp_path / "images.idx"
    labels = tmp_path / "labels.idx"
    images.write_bytes(struct.pack(">IIII", 2051, n, 28, 28)
                       + rng.integers(0, 256, n * 784, np.uint8).tobytes())
    labels.write_bytes(struct.pack(">II", 2049, n)
                       + rng.integers(0, 10, n, np.uint8).tobytes())
    return str(images), str(labels)


def test_loader_modes_write_the_jax_packages_bytes(tmp_path):
    import cv2
    rng = np.random.default_rng(6)
    images, labels = _idx(tmp_path)
    mnist = _both(tmp_path, "mnist",
                  lambda out: ["create", "mnist", images, labels, out])
    assert _folder_bytes(mnist[0]) == _folder_bytes(mnist[1])

    bins = []
    for i in range(2):
        path = tmp_path / f"data_batch_{i}.bin"
        path.write_bytes(rng.integers(0, 256, 5 * 3073, np.uint8).tobytes())
        bins.append(str(path))
    cifar = _both(tmp_path, "cifar",
                  lambda out: ["create", "cifar10", *bins, out])
    assert _folder_bytes(cifar[0]) == _folder_bytes(cifar[1])

    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    lines = []
    for i in range(4):
        img = rng.integers(0, 256, (20 + i, 24, 3), np.uint8)
        cv2.imwrite(str(img_dir / f"{i}.png"), img)
        lines.append(f"{i}.png {i % 3}")
    lines.append("missing.png 1")
    (tmp_path / "list.txt").write_text("\n".join(lines) + "\n")
    folder = _both(tmp_path, "folder", lambda out: [
        "create", "imagefolder", str(img_dir), str(tmp_path / "list.txt"),
        out, "16"])
    assert _folder_bytes(folder[0]) == _folder_bytes(folder[1])

    env = tmp_path / "env"
    items = [(b"%08d" % i, Datum(channels=3, height=4, width=4,
                                 data=rng.bytes(48), label=i % 5).encode())
             for i in range(9)]
    write_lmdb(str(env), items)
    lmdb = _both(tmp_path, "lmdb",
                 lambda out: ["convert-lmdb", str(env), out])
    assert _folder_bytes(lmdb[0]) == _folder_bytes(lmdb[1])

    split = _both(tmp_path, "split",
                  lambda out: ["split", mnist[0], out + "/part", "3"])
    assert _folder_bytes(split[0]) == _folder_bytes(split[1])
    part = _both(tmp_path, "part", lambda out: [
        "partition", mnist[0], out, "4", "2", "--shuffle=3"])
    assert _folder_bytes(part[0]) == _folder_bytes(part[1])
    part = _both(tmp_path, "rep", lambda out: [
        "partition", cifar[0], out, "4", "2", "--replicate"])
    assert _folder_bytes(part[0]) == _folder_bytes(part[1])
    mean = _both(tmp_path, "mean.bin",
                 lambda out: ["mean", mnist[0], out])
    with open(mean[0], "rb") as a, open(mean[1], "rb") as b:
        assert a.read() == b.read()
    assert loader.main([]) == 2


KEYS = {"conf", "target", "data", "batchsize", "test_samples", "device",
        "reached", "mnist_test_accuracy"}


def test_a_short_convergence_run_gives_the_jax_keys(tmp_path):
    conf = os.path.join(EXAMPLES, "mnist", "conv.conf")
    out = tmp_path / "conv.json"
    got = convergence_run.run(conf, max_steps=40, out=str(out), chunk=20,
                              test_batches=1, log=lambda s: None,
                              device="cpu")
    assert set(got) == KEYS | {"steps_run"}
    assert got["steps_run"] == 40 and not got["reached"]
    assert got["device"] == "cpu" and out.exists()
    # a target the first chunk reaches: the time-to-target keys
    got = convergence_run.run(conf, target=0.0, max_steps=40, out=str(out),
                              chunk=20, test_batches=1, log=lambda s: None,
                              device="cpu")
    assert set(got) == KEYS | {"steps_to_99", "time_to_99_seconds",
                               "train_time_to_99_seconds"}
    assert got["reached"] and got["steps_to_99"] == 20


@pytest.mark.parametrize("cb", [False, True])
def test_harvest_costs_records_every_warm_program_and_captures_none(cb):
    watch = perf.reset()
    cfg = transformer_lm(vocab_size=64, num_layers=1, embed_dim=16,
                         num_heads=2, head_dim=8, seq_len=8, batchsize=2)
    net = build_net(cfg, "kTest", {"data": {"input": (8,),
                                            "target": (8,)}})
    params = params_from_numpy(net, numpy_params(net, seed=0), device="cpu")
    spec = (ServeSpec(buckets=((2, 8),), max_new_tokens=2, cb="on",
                      cb_slots=2, cb_block_len=4) if cb else
            ServeSpec(buckets=((1, 4), (2, 8)), max_new_tokens=2))
    eng = InferenceEngine(net, spec, params, device="cpu",
                          log_fn=lambda s: None)
    eng.warmup(("generate", "predict"))
    compiles = eng.stats.compiles
    want = ({"cb_prefill", "cb_decode", "predict"} if cb
            else {"generate", "predict"})
    assert eng.harvest_costs() == (3 if cb else 4)
    assert eng.stats.compiles == compiles
    cost = watch.snapshot()["cost"]
    assert set(cost) == want
    assert all(cost[p]["flops"] > 0 for p in want)
    # the program's products: the (2, 8) predict bucket's forward holds
    # at least its projections and the head
    assert cost["predict"]["flops"] >= 2 * 2 * 8 * 16 * 64
    eng.run_batch("predict", np.ones((2, 8), np.int32),
                  np.array([8, 3], np.int32))
    assert eng.harvest_costs() == (3 if cb else 4)
    assert eng.stats.compiles == compiles
    samples = {(s.name, s.labels) for s in watch.collect()}
    for p in want:
        assert ("singa_program_flops", (("program", p),)) in samples
    perf.reset()
