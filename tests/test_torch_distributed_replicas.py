"""The port's `DistributedReplicaSet` (`singa_tpu_torch/parallel/
elastic.py`) held against the JAX package's over real transport, and
over three processes, on the CPU, with the narrowed
`examples/mnist/mlp.conf` of `tests/test_torch_elastic.py`.

- Elastic over 2 processes: the JAX `DistributedReplicaSet`
  (`jax.distributed` on the CPU) and the port's (a gloo group) from the
  JAX init, on the same streams; centers, replicas and losses within
  rtol 1e-5, atol 1e-6, as `tests/test_torch_elastic.py` holds the two
  in-process `ReplicaSet`s (the products may sum in another order).
  RandomSync draws its masks from another generator in each package, so
  its two-package check is the in-process one of that file.
- Elastic and RandomSync over 3 processes (the center chain over
  replicas 1..G-1 and `easgd_alpha` for G = 3): the port's
  `DistributedReplicaSet` against its in-process `ReplicaSet` with 3
  groups, equal under `torch.equal` (the same f32 operations on one
  thread each), and the centers equal across the processes.
"""

import os
import sys
import textwrap

import numpy as np
import pytest
import torch

from singa_tpu_torch.config.schema import model_config_from_text as tconfig
from singa_tpu_torch.core.trainer import Trainer
from singa_tpu_torch.data.synthetic import synthetic_image_batches
from singa_tpu_torch.parallel import elastic as tel

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_distributed import MNIST, _spawn  # noqa: E402
from test_torch_elastic import _mlp_text  # noqa: E402

pytestmark = pytest.mark.port
STEPS = 12
RTOL, ATOL = 1e-5, 1e-6

JAX_CHILD = textwrap.dedent('''
    import sys
    import numpy as np
    mode, pid, hostfile, out, conf = sys.argv[1], int(sys.argv[2]), \\
        sys.argv[3], sys.argv[4], sys.argv[5]
    from singa_tpu.parallel.bootstrap import distributed_init
    assert distributed_init(procs_id=pid, hostfile=hostfile)
    from singa_tpu.config.schema import model_config_from_text
    from singa_tpu.core.trainer import Trainer
    from singa_tpu.data.synthetic import synthetic_image_batches
    from singa_tpu.parallel.elastic import DistributedReplicaSet
    with open(conf) as f:
        cfg = model_config_from_text(f.read())
    tr = Trainer(cfg, {"data": {"pixel": (28, 28), "label": ()}},
                 log_fn=lambda s: None, donate=False)
    drs = DistributedReplicaSet(tr, seed=0)
    np.savez(f"{out}/jinit_{pid}.npz",
             **{k: np.asarray(v) for k, v in drs.params.items()})
    it = synthetic_image_batches(32, seed=11, stream_seed=60 + pid)
    center, hist = drs.run(it, steps=%(STEPS)d, seed=0)
    np.savez(f"{out}/jcenter_{pid}.npz",
             **{k: np.asarray(v) for k, v in center.items()})
    np.savez(f"{out}/jreplica_{pid}.npz",
             **{k: np.asarray(v) for k, v in drs.params.items()},
             losses=np.asarray([h["loss"] for h in hist]))
''' % {"STEPS": STEPS})


def _load(tmp_path, name, n):
    return [dict(np.load(tmp_path / f"{name}_{i}.npz")) for i in range(n)]


def test_distributed_replica_set_matches_the_jax_one_over_two_processes(
        tmp_path):
    conf = tmp_path / "mlp.conf"
    conf.write_text(_mlp_text("Elastic"))
    _spawn(tmp_path, "jax", conf, script=JAX_CHILD,
           env={"JAX_PLATFORMS": "cpu", "XLA_FLAGS":
                "--xla_force_host_platform_device_count=1"})
    jinit = _load(tmp_path, "jinit", 2)
    for k in jinit[0]:
        assert np.array_equal(jinit[0][k], jinit[1][k]), k
    _spawn(tmp_path, "drs", conf, tmp_path / "jinit_0.npz")
    jcenter, center = _load(tmp_path, "jcenter", 2), _load(tmp_path,
                                                           "center", 2)
    jrep, rep = _load(tmp_path, "jreplica", 2), _load(tmp_path, "replica", 2)
    for g in range(2):
        for k in jinit[0]:
            assert np.array_equal(center[g][k], center[0][k]), (g, k)
            np.testing.assert_allclose(center[g][k], jcenter[g][k],
                                       rtol=RTOL, atol=ATOL, err_msg=k)
            np.testing.assert_allclose(rep[g][k], jrep[g][k], rtol=RTOL,
                                       atol=ATOL, err_msg=(g, k))
        np.testing.assert_allclose(rep[g]["losses"], jrep[g]["losses"],
                                   rtol=RTOL)
    # the exchanges moved the replicas off their own trajectories
    assert any(not np.array_equal(rep[0][k], rep[1][k]) for k in jinit[0])


@pytest.mark.parametrize("param_type", ["Elastic", "RandomSync"])
def test_three_processes_match_the_replica_set_of_three_groups(tmp_path,
                                                               param_type):
    text = _mlp_text(param_type)
    conf = tmp_path / "mlp.conf"
    conf.write_text(text)
    _spawn(tmp_path, "drs", conf, n=3)
    centers, reps = _load(tmp_path, "center", 3), _load(tmp_path,
                                                        "replica", 3)
    tr = Trainer(tconfig(text), MNIST, log_fn=lambda s: None, device="cpu")
    rs = tel.ReplicaSet(tr, ngroups=3, seed=0)
    if param_type == "Elastic":
        assert rs.controllers[0].alpha == tel.easgd_alpha(
            tr.cfg.updater, 3)
    iters = [synthetic_image_batches(32, seed=11, stream_seed=60 + g)
             for g in range(3)]
    # one thread, as the children: a matmul's sums follow the threads
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        center, hist = rs.run(iters, steps=STEPS, seed=0)
    finally:
        torch.set_num_threads(threads)
    for k in center:
        for g in range(3):
            assert torch.equal(torch.from_numpy(centers[g][k]), center[k]), \
                (g, k)
            assert torch.equal(torch.from_numpy(reps[g][k]),
                               rs.replicas[g]["params"][k]), (g, k)
    for g in range(3):
        assert reps[g]["losses"].tolist() == [h["loss"] for h in hist[g]]
