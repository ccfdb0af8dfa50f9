"""Emit the example .conf files from the port's model zoo.

The reference ships hand-written text-proto configs under
examples/mnist/ (mlp.conf, conv.conf); the JAX package generates them
from its zoo (`singa_tpu/tools/export_examples.py`), and this is the
port's counterpart over `singa_tpu_torch.models.vision` and
`models.rbm`, through the port's own `model_config_to_text`, so a
diff of its output against examples/ shows whether the two zoos agree.
It writes under build/examples by default, never over the shipped
configs:

    python -m singa_tpu_torch.tools.export_examples [--outdir build/examples]
"""

from __future__ import annotations

import argparse
import os

from ..config import model_config_to_text
from ..models import rbm, vision

EXAMPLES = {
    "mnist/mlp.conf": lambda: vision.mlp_mnist(),
    "mnist/conv.conf": lambda: vision.lenet_mnist(),
    "mnist/rbm.conf": lambda: rbm.rbm_mnist(),
    "cifar10/quick.conf": lambda: vision.alexnet_cifar10(),
    "cifar10/alexnet.conf": lambda: vision.alexnet_cifar10_full(),
    "imagenet/alexnet.conf": lambda: vision.alexnet_imagenet(),
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--outdir", default=os.path.join("build", "examples"))
    args = ap.parse_args(argv)
    for rel, build in EXAMPLES.items():
        path = os.path.join(args.outdir, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(model_config_to_text(build()))
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
