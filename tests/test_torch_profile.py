"""How the port's trainer measures itself, on the CPU, against the JAX
package: `Trainer.profile_phases` and the `TimerInfo` line (the device
fwd/bwd/update split, `utils/profiler.py`), `ModelProto.debug`'s
`debug_info` lines, `NeuralNet.to_json`, and CostWatch's train- and
eval-step FLOPs.  A profile and a debug step
leave training as it was: a run with them equals a run without them
under `torch.equal`."""

import collections
import os

import jax
import numpy as np
import pytest
import torch

from singa_tpu.config import load_model_config as jload
from singa_tpu.core.net import build_net as jbuild
from singa_tpu.core.trainer import TimerInfo as JTimerInfo
from singa_tpu.core.trainer import Trainer as JTrainer

from singa_tpu_torch.config import load_model_config
from singa_tpu_torch.config.schema import model_config_from_dict
from singa_tpu_torch.core.net import build_net
from singa_tpu_torch.core.trainer import TimerInfo, Trainer
from singa_tpu_torch.data.synthetic import synthetic_image_batches
from singa_tpu_torch.obs import perf
from singa_tpu_torch.utils import flops, profiler
from singa_tpu_torch.weights import numpy_params, params_from_numpy

from port_fixture import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.port
EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
CONV = os.path.join(EXAMPLES, "mnist", "conv.conf")
MNIST_SHAPES = {"data": {"pixel": (28, 28), "label": ()}}


def _lenet(steps=6, display=2, batch=8, debug=False):
    cfg = load_model_config(CONV)
    cfg.train_steps, cfg.display_frequency = steps, display
    cfg.test_steps = cfg.test_frequency = 0
    cfg.debug = debug
    for layer in cfg.neuralnet.layer:
        if layer.data_param:
            layer.data_param.batchsize = batch
    return cfg


def _dropout_mlp(steps=6):
    """An MLP with dropout, so the profile and the debug step must also
    leave the trainer's generators as they were."""
    return model_config_from_dict({
        "name": "m", "train_steps": steps, "display_frequency": 2,
        "debug": True,
        "updater": {"type": "kSGD", "base_learning_rate": 0.1,
                    "momentum": 0.9, "learning_rate_change_method": "kFixed"},
        "neuralnet": {"layer": [
            {"name": "data", "type": "kShardData",
             "data_param": {"batchsize": 8}},
            {"name": "mnist", "type": "kMnistImage", "srclayers": "data",
             "mnist_param": {"norm_a": 255.0}},
            {"name": "label", "type": "kLabel", "srclayers": "data"},
            {"name": "ip1", "type": "kInnerProduct", "srclayers": "mnist",
             "inner_product_param": {"num_output": 32},
             "param": [{"name": "weight", "init_method": "kGaussain",
                        "std": 0.05}, {"name": "bias"}]},
            {"name": "drop", "type": "kDropout", "srclayers": "ip1",
             "dropout_param": {"dropout_ratio": 0.5}},
            {"name": "ip2", "type": "kInnerProduct", "srclayers": "drop",
             "inner_product_param": {"num_output": 10},
             "param": [{"name": "weight", "init_method": "kGaussain",
                        "std": 0.05}, {"name": "bias"}]},
            {"name": "loss", "type": "kSoftmaxLoss",
             "srclayers": ["ip2", "label"]}]}})


def test_run_with_phase_profile_reports_the_split():
    logs = []
    tr = Trainer(_lenet(), MNIST_SHAPES, device="cpu", log_fn=logs.append)
    tr.phase_profile = True
    p, o = tr.init(0)
    tr.run(p, o, synthetic_image_batches(8), scan_chunk=3)
    shares = tr.timer.phase_shares
    assert set(shares) == {"fwd", "bwd", "update", "coverage"}
    assert 0 < shares["fwd"] < 1 and 0 < shares["bwd"] < 1
    assert 0 < shares["update"] < 1
    assert sum(v for k, v in shares.items() if k != "coverage") == \
        pytest.approx(1.0)
    assert 0 < shares["coverage"] <= 1.0
    lines = [line for line in logs if "Time per step" in line]
    assert len(lines) == 3          # display steps 0, 2, 4
    assert all("[device: fwd" in line and
               "% of device time attributed]" in line for line in lines)
    # the convolutions' time sits in its phases: forward and backward
    by_phase = collections.Counter()
    for (ph, name), us in tr.phase_kernels.items():
        if "convolution" in name:
            by_phase[ph] += us
    assert by_phase["fwd"] > 0 and by_phase["bwd"] > 0
    assert by_phase[None] == 0


def test_profile_and_debug_leave_training_as_it_was():
    def train(measure: bool):
        cfg = _dropout_mlp()
        cfg.debug = measure
        logs = []
        tr = Trainer(cfg, MNIST_SHAPES, device="cpu", log_fn=logs.append,
                     seed=5)
        tr.phase_profile = measure
        p, o = tr.init(0)
        p, o, _ = tr.run(p, o, synthetic_image_batches(8, seed=3))
        return p, o, logs

    p1, o1, logs1 = train(True)
    p0, o0, logs0 = train(False)
    assert any(" debug:" in line for line in logs1)
    assert not any(" debug:" in line for line in logs0)
    for k in p0:
        assert torch.equal(p1[k], p0[k]), k
        assert torch.equal(o1["history"][k], o0["history"][k]), k
    # the losses logged at every display step are the same too
    assert [line for line in logs1 if line.startswith("step-")
            and "loss" in line] == \
        [line for line in logs0 if line.startswith("step-") and "loss" in line]


def test_profile_phases_leaves_params_and_generators():
    tr = Trainer(_dropout_mlp(), MNIST_SHAPES, device="cpu",
                 log_fn=lambda s: None)
    p, o = tr.init(0)
    before = {k: v.clone() for k, v in p.items()}
    tr._seed_layers(7)
    gens = {i: g.get_state() for i, g in tr._gens.items()}
    batch = next(synthetic_image_batches(8))
    shares = tr.profile_phases(p, o, batch, step=3)
    assert tr.timer.phase_shares is shares
    for k in p:
        assert torch.equal(p[k], before[k]), k
    assert all(torch.equal(o["history"][k], torch.zeros_like(p[k]))
               for k in p)
    for i, g in tr._gens.items():
        assert torch.equal(g.get_state(), gens[i])


def test_timer_info_line_equals_the_jax_packages():
    for shares in (None, {}, {"fwd": 0.4, "bwd": 0.35, "update": 0.25,
                               "coverage": 0.925},
                   {"fwd": 0.5, "bwd": 0.5, "update": 0.0}):
        t, j = TimerInfo(), JTimerInfo()
        for timer in (t, j):
            timer.add("wait", 0.0125)
            timer.add("stage", 0.003)
            timer.add("train", 0.5)
            timer.steps = 10
            timer.phase_shares = shares
        assert t.to_string() == j.to_string()


def test_classify_phase_and_the_cpu_trace(tmp_path):
    assert profiler.classify_phase(["aten::mm", "singa::fwd"]) == "fwd"
    assert profiler.classify_phase(
        ["aten::mm", "MmBackward0",
         "autograd::engine::evaluate_function: MmBackward0"]) == "bwd"
    assert profiler.classify_phase(
        ["aten::_foreach_add_", "singa::update"]) == "update"
    assert profiler.classify_phase(["aten::zeros_like"]) is None
    w = torch.randn(16, 16, requires_grad=True)
    with profiler.trace(str(tmp_path)) as prof:
        with profiler.phase("fwd"):
            y = (torch.randn(4, 16) @ w).sum()
        g, = torch.autograd.grad(y, [w])
        with torch.no_grad(), profiler.phase("update"):
            w.sub_(0.1 * g)
    shares = profiler.phase_shares(prof.events())
    assert all(shares[k] > 0 for k in ("fwd", "bwd", "update"))
    per_op, total = profiler.parse_trace_ops(str(tmp_path))
    assert per_op["aten::mm"] > 0
    assert total == pytest.approx(sum(per_op.values()))
    with profiler.StepTimer(skip_first=1) as timer:
        pass
    assert timer.times == [] and timer.mean() == 0.0


class _Event:
    """A stand-in for a profile's FunctionEvent, with the fields
    `utils.profiler.attribute` reads."""

    def __init__(self, name, device=False, parent=None, eid=0, us=0.0,
                 kernels=(), annotation=False):
        from torch.autograd import DeviceType
        self.name, self.cpu_parent, self.id = name, parent, eid
        self.device_type = DeviceType.CUDA if device else DeviceType.CPU
        self.is_user_annotation = annotation
        self.kernels = [collections.namedtuple(
            "Kernel", "name device duration")(n, 0, d) for n, d in kernels]
        self.self_cpu_time_total = 0.0
        self.time_range = type("R", (), {"elapsed_us": lambda _: us})()


def test_device_time_is_attributed_to_the_launching_op():
    fwd = _Event("singa::fwd", eid=1,
                 # a ctypes kernel joins the range open at its launch
                 kernels=[("flash_fwd_mma_kernel", 10.0)])
    mm = _Event("aten::mm", parent=fwd, eid=2, kernels=[("gemm", 30.0)])
    node = _Event("autograd::engine::evaluate_function: FlashBackward",
                  eid=3, kernels=[("flash_dq_mma_kernel", 40.0)])
    upd = _Event("singa::update", eid=4,
                 kernels=[("multi_tensor_apply_kernel", 10.0)])
    fill = _Event("aten::fill_", eid=5, kernels=[("fill_kernel", 10.0)])
    # an event sharing the op's correlation id lists the same kernels
    twin = _Event("aten::mm", parent=fwd, eid=2, kernels=[("gemm", 30.0)])
    device = [_Event(n, True, us=us) for n, us in (
        ("gemm", 30.0), ("flash_fwd_mma_kernel", 10.0),
        ("flash_dq_mma_kernel", 40.0), ("multi_tensor_apply_kernel", 10.0),
        ("fill_kernel", 10.0))]
    # the range's own span on the card's timeline is not device work
    span = _Event("singa::fwd", True, us=99.0, annotation=True)
    events = [fwd, mm, twin, node, upd, fill, *device, span]
    rows, total = profiler.attribute(events)
    assert total == 100.0
    assert rows == {("fwd", "gemm"): 30.0,
                    ("fwd", "flash_fwd_mma_kernel"): 10.0,
                    ("bwd", "flash_dq_mma_kernel"): 40.0,
                    ("update", "multi_tensor_apply_kernel"): 10.0,
                    (None, "fill_kernel"): 10.0}
    shares = profiler.phase_shares(events)
    assert shares == pytest.approx({"fwd": 40 / 90, "bwd": 40 / 90,
                                    "update": 10 / 90, "coverage": 0.9})


def test_debug_lines_equal_the_jax_packages():
    """ModelProto.debug's lines, from the same weights and batch."""
    cfg, jcfg = _lenet(debug=True), jload(CONV)
    jcfg.debug = True
    jcfg.test_steps = jcfg.test_frequency = 0
    for layer in jcfg.neuralnet.layer:
        if layer.data_param:
            layer.data_param.batchsize = 8
    tr = Trainer(cfg, MNIST_SHAPES, device="cpu", log_fn=lambda s: None)
    jtr = JTrainer(jcfg, MNIST_SHAPES, log_fn=lambda s: None)
    arrays = numpy_params(tr.train_net, seed=2)
    params = params_from_numpy(tr.train_net, arrays, device="cpu")
    jparams = {k: jax.numpy.asarray(v) for k, v in arrays.items()}
    batch = next(synthetic_image_batches(8, seed=4))
    outs, grads = tr.debug_step(params, batch, 3)
    got = tr.train_net.debug_info(params, outs, grads).splitlines()
    jouts, jgrads = jtr.debug_step(jparams, batch, 3,
                                   jax.random.PRNGKey(0))
    want = jtr.train_net.debug_info(jparams, jouts, jgrads).splitlines()
    assert [line.split(":")[0] for line in got] == \
        [line.split(":")[0] for line in want]
    names = set(tr.train_net.topo) | set(params)
    assert {line.split(":")[0] for line in got} >= set(params)
    assert {line.split(":")[0] for line in got} <= names
    for a, b in zip(got, want):
        va = [float(x) for x in a.split()[2::2]]
        vb = [float(x) for x in b.split()[2::2]]
        assert a.split()[1::2] == b.split()[1::2], (a, b)
        np.testing.assert_allclose(va, vb, rtol=1e-5, atol=1e-6,
                                   err_msg=a)


def test_to_json_equals_the_jax_packages():
    for rel in ("mnist/conv.conf", "transformer/lm_tiny.conf"):
        path = os.path.join(EXAMPLES, rel)
        shapes = (MNIST_SHAPES if "mnist" in rel else
                  {"data": {"input": (16,), "target": (16,)}})
        net = build_net(load_model_config(path), "kTrain", shapes)
        jnet = jbuild(jload(path), "kTrain", shapes)
        assert net.to_json() == jnet.to_json()


def test_train_and_eval_steps_harvest_their_flops():
    watch = perf.reset()
    cfg = _lenet()
    cfg.test_steps, cfg.test_frequency = 1, 100
    tr = Trainer(cfg, MNIST_SHAPES, device="cpu", log_fn=lambda s: None)
    p, o = tr.init(0)
    tr.run(p, o, synthetic_image_batches(8),
           test_iter_factory=lambda: synthetic_image_batches(8, seed=1))
    cost = watch.snapshot()["cost"]
    assert cost["train_step"]["flops"] == \
        flops.net_train_flops(tr.train_net)
    # MFU's time: the train timer's steps and seconds (TimerInfo)
    assert cost["train_step"]["calls"] == tr.timer.steps > 0
    assert cost["train_step"]["seconds"] == tr.timer.times["train"] > 0
    assert cost["eval_step[kTest]"]["flops"] == \
        flops.net_forward_flops(tr.test_net)
    samples = {(s.name, s.labels) for s in watch.collect()}
    assert ("singa_program_flops", (("program", "train_step"),)) in samples
    # no card, no peak: no MFU gauge on the CPU
    assert not any(name == "singa_program_mfu" for name, _ in samples)
    perf.reset()

